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
// * bf16 (v2): 4 warps, 64-row tiles, one warp per 16 query rows; scores,
//   P and the output accumulator live in mma.sync fragments in registers
//   (flash_common.cuh), so shared memory holds only the q/k/v tiles.  v1
//   staged every fragment and accumulator through shared memory (wmma);
//   PERF.md has both versions' times.
// * f32: 8 warps, 32-row tiles, f32 tiles in shared memory and plain FMAs.
// TPU artefacts left behind: the lane-replicated [blk, 128] stat tiles, the
// (1, 8, blk_k) bias broadcast and interpret mode.  Known limits, left to
// later work: no cp.async/TMA pipeline (one tile in flight per block),
// mma.sync rather than wgmma.
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
// bf16: register-resident fragments
// ---------------------------------------------------------------------------
template <int DH>
struct BfFwdLayout {
  static constexpr int LD = DH + kBfPad;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kBfTile * LD;
  static constexpr size_t kBytes = 3 * kTileBytes;   // q, k, v
};

template <int DH, bool kSingle>
__global__ void __launch_bounds__(kBfThreads) flash_fwd_bf16_kernel(FwdArgs a) {
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

  if constexpr (kSingle) {
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
  } else {
    // K3: one streaming pass with the online softmax
    for (int k0 = 0; k0 < k_end; k0 += BC) {
      __syncthreads();
      load_rows<bf16, BC, DH, LD, kBfThreads>(k_s, kp, a.sk.t, k0, t);
      load_rows<bf16, BC, DH, LD, kBfThreads>(v_s, vp, a.sv.t, k0, t);
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
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = s[j][e] > 0.5f * kNeg ? expf(s[j][e] - m_new) : 0.f;
            s[j][e] = p;
            sum += p;
          }
        const float corr = expf(m[r] - m_new);   // 0 on a row's first tile
        l[r] = l[r] * corr + quad_sum(sum);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j][2 * r] *= corr;
          o[j][2 * r + 1] *= corr;
        }
      }
      pv(s);
    }
  }
  bf16* op = static_cast<bf16*>(a.o) + bi * a.so.b + hi * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t) continue;
    const float inv = kSingle ? 1.f : 1.f / (l[r] == 0.f ? 1.f : l[r]);
    bf16* orow = op + (long long)row[r] * a.so.t + 2 * qd;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          kSingle ? pack_bf16(o[j][2 * r], o[j][2 * r + 1])
                  : pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (qd == 0)
      a.lse[(long long)bh * t + row[r]] = l[r] == 0.f ? kPos : m[r] + logf(l[r]);
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

template <int DH, bool kSingle>
int launch_dh(const FwdArgs& a, int b, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    static bool configured = false;
    const dim3 grid((a.t + kBfTile - 1) / kBfTile, b * a.h);
    return launch(flash_fwd_bf16_kernel<DH, kSingle>, BfFwdLayout<DH>::kBytes,
                  configured, grid, kBfThreads, a, s);
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
