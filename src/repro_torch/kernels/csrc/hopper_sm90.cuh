// Hopper (sm_90a) building blocks for the flash-attention and SSD-scan kernels, as
// inline PTX: shared-memory matrix descriptors and the bf16 `wgmma` products
// the kernels issue, `mbarrier` rings, 4-D TMA tile loads, 1-D bulk copies
// between device and shared memory, cluster ranks and distributed shared
// memory, and the host-side encoding of the TMA tensor
// maps (`cuTensorMapEncodeTiled`, looked up with `cudaGetDriverEntryPoint`,
// so the library links only the CUDA runtime).
//
// Tiles in shared memory.  A [R rows x D cols] bf16 tile is stored as
// SLABS slabs of [R][SW bytes], SW = min(2 D, 128), then, where D is not a
// multiple of SW/2 columns (D = 80), one tail slab of [R][2 TAIL bytes]
// (TAIL = 16 columns at D = 80).  D = 192 (MLA's [nope | rope] q/k) is three
// 64-column slabs and no tail.  Each slab is one TMA box, written in the
// swizzled layout of its own width (128B for 64 columns, 64B for 32, 32B for
// 16) that the wgmma descriptors read; a slab starts on a 1024-byte
// boundary (R = 64), so the swizzle pattern's base offset is 0.  A tile with
// a tail is loaded through two tensor maps (`TileMap`), one per box width.
//   * K-major operand (rows = M or N, cols = K): k-step kk (16 columns) of
//     rows [r0, r0 + 64) starts at slab (32 kk / SW), byte 32 kk % SW of row
//     r0; SBO = 8 rows x SW bytes, LBO unused.  A k-step in the tail slab
//     reads it with the tail's swizzle and SBO.
//   * MN-major operand (rows = K, cols = N): k-step kk starts at row 16 kk
//     of slab 0; SBO = 8 rows x SW bytes (the next 8 k rows), LBO = the slab
//     stride (the next SW/2 columns of N).  One descriptor has one swizzle,
//     so with a tail a product over all D columns is two (`wgmma_rs_tile`):
//     the main slabs' columns, then the tail's, into the accumulator's
//     registers in the same column order.
// wgmma register layouts (PTX ISA): warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4) of an m64 accumulator; register
// 4 j + e holds column 8 j + 2 (lane % 4) + (e % 2) of row 16 w + g + 8 (e / 2).
// The A operand from registers has mma.sync's m16n8k16 A layout per warp, so
// accumulator columns 16 kk .. 16 kk + 15, rounded to bf16 and paired, are the
// A registers of k-step kk without any data movement (see mma_sm90.cuh).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper_sm90 {

typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor layout type and TMA swizzle of SW-byte swizzled rows.
template <int SW>
struct SwzKind {
    static_assert(SW == 128 || SW == 64 || SW == 32, "TMA swizzles rows of 128, 64 or 32 bytes");
    static constexpr uint64_t TYPE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
    static constexpr CUtensorMapSwizzle TMA = SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : SW == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B;
};

// Swizzle geometry of a tile with D bf16 columns.
template <int D>
struct Swz {
    static constexpr int SW = D * 2 < 128 ? D * 2 : 128;   // bytes per slab row
    static constexpr int COLS = SW / 2;                     // bf16 columns per slab
    static constexpr int SLABS = D / COLS;
    static constexpr int TAIL = D - SLABS * COLS;           // columns of the tail slab (or 0)
    static constexpr int SW_T = 2 * TAIL;                   // its bytes per row
    static constexpr CUtensorMapSwizzle TMA = SwzKind<SW>::TMA;
};

// A wgmma shared-memory descriptor of rows swizzled with SW bytes:
// SBO = 8 rows x SW bytes
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
           (uint64_t((8 * SW) >> 4) << 32) | (SwzKind<SW>::TYPE << 62);
}

// K-major descriptor: rows [r0, r0 + 64) of a tile of R rows, k-step kk
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
    using G = Swz<D>;
    constexpr int SW = G::SW;
    if constexpr (G::TAIL > 0) {
        constexpr int MAIN = G::SLABS * G::COLS;
        if (kk * 16 >= MAIN)
            return make_desc<G::SW_T>(
                tile + G::SLABS * R * SW + r0 * G::SW_T + (kk * 16 - MAIN) * 2, 16);
    }
    const uint32_t off = (kk * 32 / SW) * (R * SW) + r0 * SW + (kk * 32) % SW;
    return make_desc<SW>(tile + off, 16);
}

// MN-major descriptor: k rows [16 kk, 16 kk + 16) of a tile of R rows, the
// columns of its main slabs (all D columns when it has no tail)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
    constexpr int SW = Swz<D>::SW;
    return make_desc<SW>(tile + kk * 16 * SW, R * SW);
}

// MN-major descriptor of the tail slab: k rows [16 kk, 16 kk + 16)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn_tail(uint32_t tile, int kk) {
    using G = Swz<D>;
    static_assert(G::TAIL > 0, "desc_mn_tail: the tile has no tail slab");
    return make_desc<G::SW_T>(tile + G::SLABS * R * G::SW + kk * 16 * G::SW_T, R * G::SW_T);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that read and write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// ---- wgmma products (bf16 in, fp32 accumulate) ---------------------------------
// d (m64 x nN, fp32) = A B (+ d if scale_d), both operands in shared memory:
// A K-major (TA = 0) or M-major (TA = 1), B K-major (TB = 0) or N-major (TB = 1)
#define HOPPER_SM90_D8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                       "+f"(d[6]), "+f"(d[7])
#define HOPPER_SM90_D16 HOPPER_SM90_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_SM90_D32 HOPPER_SM90_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
                        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
                        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                        "+f"(d[30]), "+f"(d[31])
#define HOPPER_SM90_D64 HOPPER_SM90_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
                        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
                        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
                        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
                        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
                        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
                        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
    static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss: n16, 32, 64 or 128");
    if constexpr (N == 16) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
            : HOPPER_SM90_D8
            : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
    } else if constexpr (N == 32) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p, 1, 1, %19, %20;\n}\n"
            : HOPPER_SM90_D16
            : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
    } else if constexpr (N == 64) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, %35, %36;\n}\n"
            : HOPPER_SM90_D32
            : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, %67, %68;\n}\n"
            : HOPPER_SM90_D64
            : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
    }
}

// d (m64 x n16, fp32) = A B (+ d if scale_d): A (64 x 16 bf16) from registers in
// the accumulator-to-A layout, B in shared memory, MN-major if TB else K-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : HOPPER_SM90_D8
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// d (m64 x n32, fp32) = A B (+ d if scale_d): A (64 x 16 bf16) from registers in
// the accumulator-to-A layout, B in shared memory, MN-major if TB else K-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// d (m64 x n64, fp32) = A B (+ d if scale_d): A (64 x 16 bf16) from registers in
// the accumulator-to-A layout, B in shared memory, MN-major if TB else K-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// d (m64 x n128, fp32) = A B (+ d if scale_d): A (64 x 16 bf16) from registers in
// the accumulator-to-A layout, B in shared memory, MN-major if TB else K-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// d (m64 x n80, fp32) = A B (+ d if scale_d): A (64 x 16 bf16) from registers in
// the accumulator-to-A layout, B in shared memory, MN-major if TB else K-major.
// The product of the uniform 32-byte route at D = 80 (five 16-column slabs),
// which tools/kernel_ab.py --make-variant sw32 builds to time against the
// two-slab tiles
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n80(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : HOPPER_SM90_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// B MN-major (TB = 1, the default) or K-major (TB = 0)
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
    static_assert(N == 16 || N == 32 || N == 64 || N == 80 || N == 128,
                  "wgmma_rs: n16, 32, 64, 80 or 128");
    if constexpr (N == 16) wgmma_rs_m64n16<TB>(d, a, desc_b, scale_d);
    else if constexpr (N == 32) wgmma_rs_m64n32<TB>(d, a, desc_b, scale_d);
    else if constexpr (N == 64) wgmma_rs_m64n64<TB>(d, a, desc_b, scale_d);
    else if constexpr (N == 80) wgmma_rs_m64n80<TB>(d, a, desc_b, scale_d);
    else wgmma_rs_m64n128<TB>(d, a, desc_b, scale_d);
}

// d (m64 x nD) += A B, B an MN-major [R x D] tile at `tile`, k rows
// [16 kk, 16 kk + 16): one product over the main slabs' columns and, where
// the tile has a tail slab, one over the tail's, into d's last 2 TAIL
// registers (the accumulator layout's column order).  Past 128 columns
// (D = 192: three 64-column slabs) the first two slabs are one m64n128
// product and the rest a second one into d's registers from 64 on.
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint32_t tile, int kk) {
    using G = Swz<D>;
    if constexpr (G::TAIL == 0 && D > 128) {
        static_assert(D - 128 <= 128 && 128 % G::COLS == 0, "wgmma_rs_tile: D <= 256");
        wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(&d[0]), a, desc_mn<D, R>(tile, kk), 1);
        wgmma_rs<D - 128>(*reinterpret_cast<float(*)[(D - 128) / 2]>(&d[64]), a,
                          make_desc<G::SW>(tile + (128 / G::COLS) * R * G::SW + kk * 16 * G::SW,
                                           R * G::SW),
                          1);
    } else if constexpr (G::TAIL == 0) {
        wgmma_rs<D>(d, a, desc_mn<D, R>(tile, kk), 1);
    } else {
        constexpr int MAIN = G::SLABS * G::COLS;
        wgmma_rs<MAIN>(*reinterpret_cast<float(*)[MAIN / 2]>(&d[0]), a, desc_mn<D, R>(tile, kk),
                       1);
        wgmma_rs<G::TAIL>(*reinterpret_cast<float(*)[G::TAIL / 2]>(&d[MAIN / 2]), a,
                          desc_mn_tail<D, R>(tile, kk), 1);
    }
}

// The shared-memory address of (row, col) of a swizzled tile of R rows:
// TMA's swizzle XORs the 16-byte chunk index (address bits 4..) with the
// address bits from 7 up, within each SW-byte row group of 8 (SW / 16
// chunks); a column of the tail slab with the tail's SW_T.
template <int D, int R>
__device__ __forceinline__ uint32_t swz_addr(uint32_t tile, int row, int col) {
    using G = Swz<D>;
    constexpr int SW = G::SW;
    if constexpr (G::TAIL > 0) {
        constexpr int MAIN = G::SLABS * G::COLS;
        if (col >= MAIN) {
            const uint32_t off = G::SLABS * R * SW + row * G::SW_T + (col - MAIN) * 2;
            return tile + (off ^ (((off >> 7) & (G::SW_T / 16 - 1)) << 4));
        }
    }
    const uint32_t off = (col / G::COLS) * (R * SW) + row * SW + (col % G::COLS) * 2;
    return tile + (off ^ (((off >> 7) & (SW / 16 - 1)) << 4));
}

// Four 8x8 bf16 matrices from shared memory (mma's A-fragment layout when
// lane l gives row l % 16, column 8 (l / 16) of a 16 x 16 block)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// 2^x on the special-function unit in one instruction (subnormal results
// flush to 0; 2^-inf = 0), where exp2f adds a range fix-up around it
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// (a, b) as bf16 pairs hi + lo, a = hi + lo to ~16 bits.  Round: hi to
// nearest, |lo| <= 2^-8 |a| (two conversions); else hi truncated (a mask),
// |lo| < 2^-7 |a| (one conversion), for products where lo meets only an
// exact bf16 operand, so no lo x lo term is dropped.
template <bool Round>
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
    float ra, rb;
    if constexpr (Round) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        hi = *reinterpret_cast<const uint32_t*>(&h);
        ra = __low2float(h);
        rb = __high2float(h);
    } else {
        const uint32_t ua = __float_as_uint(a) & 0xffff0000u, ub = __float_as_uint(b) & 0xffff0000u;
        hi = __byte_perm(ua, ub, 0x7632);
        ra = __uint_as_float(ua);
        rb = __uint_as_float(ub);
    }
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - ra, b - rb);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes from / to shared memory at a 32-bit shared address
__device__ __forceinline__ uint4 lds_u4(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}
__device__ __forceinline__ void sts_u4(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
}
// four 8x8 bf16 matrices to shared memory: register i of lane l holds row
// l / 4, columns 2 (l % 4) and + 1 of matrix i (an accumulator fragment,
// paired to bf16); lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
}
// makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operands, TMA); a barrier among the writers follows
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier among `threads` threads (a multiple of 32) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrives at hardware barrier `id` without waiting for it: the shared-memory
// writes before it are visible to the threads that `named_sync` on it
__device__ __forceinline__ void named_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// moves registers between warpgroups: every warp of the warpgroup executes
// it, and the block's total stays within the register file.  ptxas gives
// the code after an increase the larger budget.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
// waits until the phase of the given parity has completed; a wait of more
// than ~2^35 cycles (~20 s) traps, so a lost arrival faults the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    long long start = 0;
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (done) return;
        if (start == 0) start = clock64();
        else if (clock64() - start > (1ll << 35)) __trap();
    }
}

// ---- TMA ------------------------------------------------------------------
// One box of a 4-D tensor map into shared memory; completion (the box's
// bytes, zero-filled where it leaves the tensor) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// `bytes` (a multiple of 16) copied as they are from device memory at `src`
// to shared memory at `dst` (both 16-byte aligned); completion is reported
// to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// `bytes` (a multiple of 16) copied from shared memory at `src` to device
// memory at `dst` (both 16-byte aligned), asynchronously: the shared-memory
// writes before it need fence_proxy_async and a barrier among the writers;
// `bulk_commit` closes a group of such stores, `bulk_wait_read<n>` waits
// until at most n groups still read their shared memory, `bulk_wait<n>`
// until at most n groups are still writing.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor maps of a [D, rows, heads, batch] operand: boxes of SW/2
// columns for the main slabs and, where the tile has a tail, boxes of TAIL
// columns with the tail's swizzle.
template <int D, bool = (Swz<D>::TAIL > 0)>
struct TileMap {
    CUtensorMap slabs;
};
template <int D>
struct TileMap<D, true> {
    CUtensorMap slabs, tail;
};

// Loads rows [row0, row0 + R) of (head, batch) of a [D, rows, heads, batch]
// map as its slabs (boxes of SW/2 columns x R rows) into `tile`.
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(bf16_t* tile, const CUtensorMap* map,
                                              uint64_t* bar, int row0, int head, int batch) {
    static_assert(Swz<D>::TAIL == 0, "a tile with a tail slab loads through its TileMap");
#pragma unroll
    for (int s = 0; s < Swz<D>::SLABS; ++s)
        tma_load_4d(tile + s * R * Swz<D>::COLS, map, bar, s * Swz<D>::COLS, row0, head, batch);
}

// The same through a TileMap: the main slabs, then the tail slab's box (the
// caller's expect_tx counts the whole tile, R x D x 2 bytes)
template <int D, int R>
__device__ __forceinline__ void tma_load_tile(bf16_t* tile, const TileMap<D>* map,
                                              uint64_t* bar, int row0, int head, int batch) {
    using G = Swz<D>;
#pragma unroll
    for (int s = 0; s < G::SLABS; ++s)
        tma_load_4d(tile + s * R * G::COLS, &map->slabs, bar, s * G::COLS, row0, head, batch);
    if constexpr (G::TAIL > 0)
        tma_load_4d(tile + G::SLABS * R * G::COLS, &map->tail, bar, G::SLABS * G::COLS, row0,
                    head, batch);
}

// ---- clusters ---------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
// every thread of every block of the cluster; orders shared-memory writes
// before it with reads after it across the cluster
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(addr)
                 : "memory");
    return v;
}

// ---- host: tensor maps --------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                               12000, cudaEnableDefault, &q);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A 4-D bf16 tensor map: dims[0] contiguous, strides of dims 1..3 in
// elements, boxes of box[0] x box[1] x 1 x 1.  Elements past a dim's extent
// read as zeros.  Returns a CUDA error code (0 on success).
inline int encode_tiled(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                        const int64_t (&strides)[3], int box0, int box1,
                        CUtensorMapSwizzle swizzle) {
    const EncodeTiledFn fn = encode_tiled_fn();
    if (!fn) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t bytes[3] = {cuuint64_t(strides[0]) * 2, cuuint64_t(strides[1]) * 2,
                                 cuuint64_t(strides[2]) * 2};
    const cuuint32_t box[4] = {cuuint32_t(box0), cuuint32_t(box1), 1, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                          dims, bytes, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A [B, heads, rows, D] bf16 view (element strides sb, sh, ss; last dim
// contiguous) as 4-D maps (D, rows, heads, B) read in boxes of SW/2 columns
// x box_rows rows, SW-byte swizzled, and, for a tile with a tail, of TAIL
// columns x box_rows rows, SW_T-byte swizzled.  Rows at or past `rows` read
// as zeros.
template <int D>
int encode_map(TileMap<D>* map, const void* base, int B, int heads, int rows, int64_t sb,
               int64_t sh, int64_t ss, int box_rows) {
    using G = Swz<D>;
    const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows > 0 ? rows : 1),
                                cuuint64_t(heads), cuuint64_t(B)};
    const int64_t strides[3] = {ss, sh, sb};
    int rc = encode_tiled(&map->slabs, base, dims, strides, G::COLS, box_rows, G::TMA);
    if constexpr (G::TAIL > 0)
        if (!rc)
            rc = encode_tiled(&map->tail, base, dims, strides, G::TAIL, box_rows,
                              SwzKind<G::SW_T>::TMA);
    return rc;
}

}  // namespace hopper_sm90
