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
// the H100 turns compute-bound in bf16.  At t 512 (K4's shapes) 3.2 GFLOP
// over 25 MB: memory.
//
// Design: one thread block per (query tile, batch*head); the block loops
// over the key tiles the Pallas grid walked in order on its "arbitrary"
// axis, skipping tiles wholly above the diagonal when causal; the
// heaviest causal tiles launch first.  Keys at or past t are no keys at
// all (p = 0); rows at or past t are never read or written.
// * K3 keeps each row's running max and denominator and rescales its
//   output accumulator per key tile; P is rounded to the input dtype
//   BEFORE the division by the denominator (acc / l at the end), as the
//   TPU kernel does.
// * K4 (the sequence fits one Pallas key block, t <= blk_k) walks the key
//   tiles twice: once for each row's max and denominator, once for P.V
//   with P normalised THEN rounded — K4's rounding point (p / l before the
//   cast).
// * bf16 K3 (v3): wgmma on TMA tiles.  A block is two warpgroups on 128
//   query rows (64 each: wgmma's M); both fit in registers at dh 128
//   (246 a thread, no spill), so no producer warpgroup and no setmaxnreg:
//   thread 0 issues the TMA copies, prefetching key tile j + 1 before
//   tile j is computed (one barrier per tile).  Q (once) and a two-stage
//   ring of K and V tiles (128 keys) arrive by TMA from 4-D tensor maps
//   over the bthd views ((dh, h, t, b) with the projection's strides;
//   rows past t read as zeros), completion on mbarriers, 128-byte
//   swizzled panels of 64 head columns.  S = Q K^T is wgmma m64n128k16
//   with both operands in shared memory; the softmax runs in registers in
//   base 2 (the scale times log2 e folded into one FFMA per score,
//   ex2.approx), with a branch-free path for interior tiles (wholly below
//   the diagonal, every key below t, no bias) and masking only on
//   diagonal, ragged and biased tiles (the bias slice read once per
//   tile); P, rounded to bf16 before the division by l, is the register
//   A operand of O += P V (wgmma m64n{dh}k16, V MN-major through the
//   descriptor's transpose bit).  Blocks start in groups of 8 (batch,
//   head) slices, so the K/V that running blocks read stays in L2 (the
//   kernel is bound by moving K/V tiles: without its products and
//   exponentials it still takes ~75% of its time, PERF.md), and within a
//   group every slice's heaviest causal query tile goes first, so the
//   lightest blocks fill the last wave.
// * bf16 K4 (v2): 4 warps, 64-row tiles, one warp per 16 query rows;
//   scores, P and the output accumulator live in mma.sync fragments in
//   registers (flash_common.cuh), so shared memory holds only the q/k/v
//   tiles, loaded with plain 16-byte loads between barriers.
// * f32: 8 warps, 32-row tiles, f32 tiles in shared memory and plain FMAs.
// TPU artefacts left behind: the lane-replicated [blk, 128] stat tiles, the
// (1, 8, blk_k) bias broadcast and interpret mode.  Known limits, left to
// later work: each 128-row query block reads every K/V tile below its
// diagonal from L2 on its own (sharing them across a cluster by TMA
// multicast is the next step); K4 is still v2.
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes through cudart

#include "flash_common.cuh"

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
// bf16 K4 (v2): register-resident mma.sync fragments
// ---------------------------------------------------------------------------
template <int DH>
struct BfFwdLayout {
  static constexpr int LD = DH + kBfPad;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kBfTile * LD;
  static constexpr size_t kBytes = 3 * kTileBytes;   // q, k, v
};

template <int DH>
__global__ void __launch_bounds__(kBfThreads) flash_fwd_bf16_single_kernel(FwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = BfFwdLayout<DH>;
  constexpr int LD = L::LD, BR = kBfTile, BC = kBfTile;
  constexpr int NJ = BC / 8;   // score column blocks per key tile
  constexpr int ND = DH / 8;   // output column blocks
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BR * LD;
  bf16* v_s = k_s + BC * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int t = a.t;
  const int n_q = (t + BR - 1) / BR;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BR;   // heaviest causal tile first
  const bf16* kp = static_cast<const bf16*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const int r0 = warp * 16;                 // this warp's rows in the tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_rows<bf16, BR, DH, LD, kBfThreads>(
      q_s, static_cast<const bf16*>(a.q) + bi * a.sq.b + hi * a.sq.h, a.sq.t, q0, t);
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int k_end = a.causal ? min(t, q0 + BR) : t;

  // s = this warp's 16 rows x 64 keys of key tile k0, scaled/biased/masked;
  // returns the rows' maxima over the tile
  auto scores = [&](float (&s)[NJ][4], int k0, float (&mx)[2]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t af[4];
      load_a<LD>(af, q_s, r0, kk, g, qd);
      mma_abt<NJ, LD>(s, af, k_s, 0, kk, g, qd);
    }
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = masked_score(a, bias, s[j][e], row[e >> 1], k0 + 8 * j + 2 * qd + (e & 1));
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
  };

  // out += P . V for key tile k0 from the probabilities in s
  auto pv = [&](float (&s)[NJ][4]) {
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      mma_ab<ND, LD>(o, pf, v_s, 16 * kc, lane);
    }
  };

  // K4 pass 1: each row's max and denominator over all of its keys
  for (int k0 = 0; k0 < k_end; k0 += BC) {
    __syncthreads();
    load_rows<bf16, BC, DH, LD, kBfThreads>(k_s, kp, a.sk.t, k0, t);
    __syncthreads();
    float s[NJ][4], mx[2];
    scores(s, k0, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          sum += s[j][e] > 0.5f * kNeg ? expf(s[j][e] - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
      m[r] = m_new;
    }
  }
  // K4 pass 2: P = exp(s - m) / l, rounded, then P.V
  const float l_safe[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  for (int k0 = 0; k0 < k_end; k0 += BC) {
    __syncthreads();
    load_rows<bf16, BC, DH, LD, kBfThreads>(k_s, kp, a.sk.t, k0, t);
    load_rows<bf16, BC, DH, LD, kBfThreads>(v_s, vp, a.sv.t, k0, t);
    __syncthreads();
    float s[NJ][4], mx[2];
    scores(s, k0, mx);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = s[j][e] > 0.5f * kNeg ? expf(s[j][e] - m[r]) / l_safe[r] : 0.f;
      }
    pv(s);
  }

  bf16* op = static_cast<bf16*>(a.o) + bi * a.so.b + hi * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t) continue;
    bf16* orow = op + (long long)row[r] * a.so.t + 2 * qd;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
    if (qd == 0)
      a.lse[(long long)bh * t + row[r]] = l[r] == 0.f ? kPos : m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16 K3 v3: wgmma on TMA-filled, 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two consumer warpgroups take 64 query rows each (128 a block); the key
// tile is 128 keys.  Shared memory holds tiles as panels of 64 head
// columns (128 bytes a row), 128 rows a panel, in the 128-byte swizzle
// that TMA writes and wgmma reads: Q once, and a two-stage ring of K and
// V tiles, each stage with its own mbarriers.
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kWgRows = 128;      // query rows per block (64 a warpgroup)
constexpr int kWgKeys = 128;      // keys per tile
constexpr int kWgStages = 2;
constexpr int kPanel = 64;        // head columns per swizzled panel
constexpr int kHeadGroup = 8;     // (batch, head) slices in flight together

template <int DH>
struct WgLayout {
  static constexpr int NP = DH / kPanel;
  static constexpr uint32_t kPanelBytes = 128 * kWgRows;   // 128 rows of 128 B
  static constexpr uint32_t kTileBytes = NP * kPanelBytes;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTileBytes;
  static constexpr uint32_t kV = kK + kWgStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kWgStages * kTileBytes;   // 5 mbarriers
  static constexpr size_t kBytes = kBar + 64 + 1024;   // + slack to align to 1024
};

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
// one box (64 head columns x 128 rows of one (batch, head)) into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int d0, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(d0), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared
// address `addr` (1024-byte-aligned atoms): `lbo`/`sbo` in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching wgmma's registers across the async window
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate; d[j][e] is the PTX
// accumulator register 4 j + e (rows 16 w + g (e < 2) and + 8, columns
// 8 j + 2 q + (e & 1) for warp w of the warpgroup, lane 4 g + q) — the
// mma.sync m16n8 C layout, per warp.  ss: A and B from shared memory,
// both K-major; rs: A from registers (the mma.sync m16n8k16 A layout),
// B from shared memory MN-major (transposed).
template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[16][4], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <int DH>
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
  // blocks start in launch order: the (batch, head) slices go in groups of
  // kHeadGroup, so the K/V the running blocks read stays within L2, and
  // within a group every slice's heaviest causal tile goes first
  const int n_bh = gridDim.x;
  const int lin = blockIdx.x + n_bh * blockIdx.y;
  const int grp = lin / (kHeadGroup * n_q);
  const int in_grp = min(kHeadGroup, n_bh - grp * kHeadGroup);
  const int r_in = lin - grp * kHeadGroup * n_q;
  const int bh = grp * kHeadGroup + r_in % in_grp;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = (n_q - 1 - r_in / in_grp) * BR;
  const float* bias = a.bias ? a.bias + (long long)bh * t : nullptr;
  const int row[2] = {q0 + 64 * wg + 16 * wi + g, q0 + 64 * wg + 16 * wi + g + 8};
  const int k_end = a.causal ? min(t, q0 + BR) : t;
  const int n_k = (k_end + BC - 1) / BC;

  // the consumers prefetch: thread 0 issues tile j + 1 before tile j is
  // computed (no producer warp)
  auto issue_kv = [&](int j) {
    const int st = j % kWgStages;
    mbar_expect(bar_k(st), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(k_s + st * L::kTileBytes + p * L::kPanelBytes, tk, bar_k(st), kPanel * p, hi,
               j * BC, bi);
    mbar_expect(bar_v(st), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      tma_load(v_s + st * L::kTileBytes + p * L::kPanelBytes, tv, bar_v(st), kPanel * p, hi,
               j * BC, bi);
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
    issue_kv(0);
  }

  const float c = a.scale * kLog2e;
  const float thr = 0.5f * kNeg * kLog2e;   // the reference's p = 0 test, base 2
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};   // running row max of y
  float l[2] = {0.f, 0.f};                // this thread's part of the denominator
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BC;
    const int st = j % kWgStages;
    const int parity = (j / kWgStages) & 1;
    if (j > 0) __syncthreads();   // tile j - 1 read by every warpgroup: its stage is free
    if (tid == 0 && j + 1 < n_k) issue_kv(j + 1);
    mbar_wait(bar_k(st), parity);

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
    if (interior) {
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
      // diagonal, ragged or biased tile (or a scale <= 0): masked_score's
      // semantics, the bias slice read once per tile
      float mx[2] = {-INFINITY, -INFINITY};
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
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
      }
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

    // out += P V: P rounded to bf16 before the division by l (K3's
    // rounding point) as wgmma's register A operand; V MN-major — a
    // k-step is 16 key rows (2048 bytes), the next 64 head columns a
    // panel further (LBO)
    uint32_t pf[NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      pf[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pf[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pf[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pf[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    mbar_wait(bar_v(st), parity);
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
    const float lr = quad_sum(l[r]);
    if (row[r] >= t) continue;
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
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
// f32: tiles in shared memory, plain FMAs
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
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(FwdArgs a) {
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

  load_rows<float, BR, DH, LDT, kF32Threads>(
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
      load_rows<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
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
      load_rows<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows<float, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
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
      load_rows<float, BC, DH, LDT, kF32Threads>(k_s, kp, a.sk.t, k0, t);
      load_rows<float, BC, DH, LDT, kF32Threads>(v_s, vp, a.sv.t, k0, t);
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
  store_rows<BR, DH, LDT>(static_cast<float*>(a.o) + bi * a.so.b + hi * a.so.h,
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of one bf16 [b, t, h, dh] view, as the 4-D tensor (dh, h,
// t, b) with the view's strides: boxes of 64 head columns x 128 rows of
// one (batch, head), 128-byte swizzled; rows past t read as zeros.
// cuTensorMapEncodeTiled is looked up through cudart's entry-point query,
// so the library links nothing but cudart.
int make_map(CUtensorMap* map, const void* base, const Strides& st, int b, int h, int t,
             int dh) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000,
        cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                            reinterpret_cast<void**>(&encode),
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.t * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)kWgRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_wgmma(const FwdArgs& a, int b, bool& configured, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, a.q, a.sq, b, a.h, a.t, DH);
  if (!rc) rc = make_map(&tk, a.k, a.sk, b, a.h, a.t, DH);
  if (!rc) rc = make_map(&tv, a.v, a.sv, b, a.h, a.t, DH);
  if (rc) return rc;
  if (!configured) {   // once, on the first (uncaptured) launch
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)WgLayout<DH>::kBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(b * a.h, (a.t + kWgRows - 1) / kWgRows);
  flash_fwd_bf16_wgmma_kernel<DH><<<grid, kWgThreads, WgLayout<DH>::kBytes, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int DH, bool kSingle>
int launch_dh(const FwdArgs& a, int b, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    static bool configured = false;
    if constexpr (kSingle) {   // K4: v2
      const dim3 grid((a.t + kBfTile - 1) / kBfTile, b * a.h);
      return launch(flash_fwd_bf16_single_kernel<DH>, BfFwdLayout<DH>::kBytes,
                    configured, grid, kBfThreads, a, s);
    } else {                   // K3: v3
      return launch_wgmma<DH>(a, b, configured, s);
    }
  }
  static bool configured = false;
  const dim3 grid((a.t + kF32Tile - 1) / kF32Tile, b * a.h);
  return launch(flash_fwd_f32_kernel<DH, kSingle>, F32FwdLayout<DH>::kBytes,
                configured, grid, kF32Threads, a, s);
}

template <bool kSingle>
int launch_any(const FwdArgs& a, int b, int dh, int is_bf16, cudaStream_t s) {
  return dh == 64 ? launch_dh<64, kSingle>(a, b, is_bf16, s)
                  : launch_dh<128, kSingle>(a, b, is_bf16, s);
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
  if (b <= 0 || h <= 0 || t <= 0 || (dh != 64 && dh != 128) || b * h > 65535)
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
