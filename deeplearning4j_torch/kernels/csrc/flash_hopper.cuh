// Hopper machinery shared by the bf16 flash kernels on wgmma (flash_fwd.cu:
// K3 v3 and K4 v3 and their builds past head dim 128, flash_bwd.cu: K5 v3
// and K6 v3 and their builds past head dim 128): TMA tensor maps over the bthd views, mbarriers,
// wgmma descriptors of 128-byte-swizzled tiles, the wgmma instructions,
// base-2 exponentials and cp.async.
//
// Shared memory holds a tile as panels of 64 head columns (128 bytes a
// row) in the 128-byte swizzle that TMA writes and wgmma reads; a panel
// of R rows takes 128 R bytes and starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes through cudart

#include "flash_common.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPanel = 64;        // head columns per swizzled panel
constexpr int kHeadGroup = 8;     // (batch, head) slices in flight together

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one box (64 head columns x the map's rows of one (batch, head)) into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int d0, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(d0), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// 4 bytes global -> shared without a register; `n` = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared
// address `addr` (1024-byte-aligned atoms): `lbo`/`sbo` in bytes.  A
// K-major operand (head dim contiguous) takes (16, 1024) and a k-step
// adds 32 bytes inside the swizzled row, a panel every four k-steps; an
// MN-major one (read through the transpose bit) takes (the panel stride,
// 1024) and a k-step of 16 rows adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// make this thread's plain shared-memory stores visible to wgmma's reads
// (the async proxy); a barrier then orders them for the other threads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// FLASH_WG_D4(j) is accumulator column block j's four operands.
#define FLASH_WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
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
  // warpgroup 1's 128 output columns of K5 and K6 at head dim 320 (as
  // Wgmma<192>::ss_tb)
  static __device__ __forceinline__ void ss_tb(float (&d)[16][4], uint64_t da, uint64_t db,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3),
          FLASH_WG_D4(4), FLASH_WG_D4(5), FLASH_WG_D4(6), FLASH_WG_D4(7),
          FLASH_WG_D4(8), FLASH_WG_D4(9), FLASH_WG_D4(10), FLASH_WG_D4(11),
          FLASH_WG_D4(12), FLASH_WG_D4(13), FLASH_WG_D4(14), FLASH_WG_D4(15)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The backward's score quarters past head dim 256: 64 rows x 16 columns
// of S^T and dP^T (K5) or S and dP (K6) (ss, both K-major).
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[2][4], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The backward's half tiles at head dims 192 and 256: 64 rows x 32
// columns of S or dP (ss, both K-major).
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[4][4], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The whole head dim in one instruction at 192 and 256 (an accumulator
// of 96 or 128 registers a thread): rs, the forward's O += P V and the
// backward's dQ += dS K; ss_tb, A K-major and B MN-major (transposed),
// both from shared memory, the backward's dV += P^T dO and dK += dS^T Q
// with P^T and dS^T staged in shared memory.
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void ss_tb(float (&d)[24][4], uint64_t da, uint64_t db,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3),
          FLASH_WG_D4(4), FLASH_WG_D4(5), FLASH_WG_D4(6), FLASH_WG_D4(7),
          FLASH_WG_D4(8), FLASH_WG_D4(9), FLASH_WG_D4(10), FLASH_WG_D4(11),
          FLASH_WG_D4(12), FLASH_WG_D4(13), FLASH_WG_D4(14), FLASH_WG_D4(15),
          FLASH_WG_D4(16), FLASH_WG_D4(17), FLASH_WG_D4(18), FLASH_WG_D4(19),
          FLASH_WG_D4(20), FLASH_WG_D4(21), FLASH_WG_D4(22), FLASH_WG_D4(23)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[24][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3),
          FLASH_WG_D4(4), FLASH_WG_D4(5), FLASH_WG_D4(6), FLASH_WG_D4(7),
          FLASH_WG_D4(8), FLASH_WG_D4(9), FLASH_WG_D4(10), FLASH_WG_D4(11),
          FLASH_WG_D4(12), FLASH_WG_D4(13), FLASH_WG_D4(14), FLASH_WG_D4(15),
          FLASH_WG_D4(16), FLASH_WG_D4(17), FLASH_WG_D4(18), FLASH_WG_D4(19),
          FLASH_WG_D4(20), FLASH_WG_D4(21), FLASH_WG_D4(22), FLASH_WG_D4(23)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void ss_tb(float (&d)[32][4], uint64_t da, uint64_t db,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3),
          FLASH_WG_D4(4), FLASH_WG_D4(5), FLASH_WG_D4(6), FLASH_WG_D4(7),
          FLASH_WG_D4(8), FLASH_WG_D4(9), FLASH_WG_D4(10), FLASH_WG_D4(11),
          FLASH_WG_D4(12), FLASH_WG_D4(13), FLASH_WG_D4(14), FLASH_WG_D4(15),
          FLASH_WG_D4(16), FLASH_WG_D4(17), FLASH_WG_D4(18), FLASH_WG_D4(19),
          FLASH_WG_D4(20), FLASH_WG_D4(21), FLASH_WG_D4(22), FLASH_WG_D4(23),
          FLASH_WG_D4(24), FLASH_WG_D4(25), FLASH_WG_D4(26), FLASH_WG_D4(27),
          FLASH_WG_D4(28), FLASH_WG_D4(29), FLASH_WG_D4(30), FLASH_WG_D4(31)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32][4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : FLASH_WG_D4(0), FLASH_WG_D4(1), FLASH_WG_D4(2), FLASH_WG_D4(3),
          FLASH_WG_D4(4), FLASH_WG_D4(5), FLASH_WG_D4(6), FLASH_WG_D4(7),
          FLASH_WG_D4(8), FLASH_WG_D4(9), FLASH_WG_D4(10), FLASH_WG_D4(11),
          FLASH_WG_D4(12), FLASH_WG_D4(13), FLASH_WG_D4(14), FLASH_WG_D4(15),
          FLASH_WG_D4(16), FLASH_WG_D4(17), FLASH_WG_D4(18), FLASH_WG_D4(19),
          FLASH_WG_D4(20), FLASH_WG_D4(21), FLASH_WG_D4(22), FLASH_WG_D4(23),
          FLASH_WG_D4(24), FLASH_WG_D4(25), FLASH_WG_D4(26), FLASH_WG_D4(27),
          FLASH_WG_D4(28), FLASH_WG_D4(29), FLASH_WG_D4(30), FLASH_WG_D4(31)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
#undef FLASH_WG_D4

// Place `lin` of the launch order over n_bh (batch, head) slices of
// n_tiles tiles: the slices go in groups of kHeadGroup, so the tiles the
// running blocks share stay within L2; within a group every slice's tile
// 0 goes first, then tile 1, ...  Returns (batch * head slice, tile
// index in launch order).
__device__ __forceinline__ int2 grouped_index(int lin, int n_bh, int n_tiles) {
  const int grp = lin / (kHeadGroup * n_tiles);
  const int in_grp = min(kHeadGroup, n_bh - grp * kHeadGroup);
  const int r_in = lin - grp * kHeadGroup * n_tiles;
  return make_int2(grp * kHeadGroup + r_in % in_grp, r_in / in_grp);
}

// grouped_index of this block, on a grid of (slices, tiles)
__device__ __forceinline__ int2 grouped_block(int n_tiles) {
  return grouped_index(blockIdx.x + gridDim.x * blockIdx.y, gridDim.x, n_tiles);
}

// a barrier of the block's 256 threads that may sit in code each
// warpgroup reaches on its own path (barrier.sync without .aligned)
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 1, 256;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of one bf16 [b, t, h, dh] view, as the 4-D tensor (dh, h,
// t, b) with the view's strides: boxes of 64 head columns x `rows` rows
// of one (batch, head), 128-byte swizzled; rows past t read as zeros.
// cuTensorMapEncodeTiled is looked up through cudart's entry-point query,
// so the library links nothing but cudart.
inline int make_map(CUtensorMap* map, const void* base, const Strides& st, int b, int h, int t,
                    int dh, int rows) {
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
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace flash
