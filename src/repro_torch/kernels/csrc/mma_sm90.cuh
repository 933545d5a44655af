// Warp-level building blocks shared by the flash-attention kernels:
// 16-byte cp.async copies, ldmatrix fragment loads and the bf16 mma.sync
// m16n8k16 product (fp32 accumulate), with the fragment layouts the PTX ISA
// fixes.  For an m16n8k16 product a warp holds
//   A (16x16, row-major): a0 rows 0-7 / cols 0-7, a1 rows 8-15 / cols 0-7,
//                         a2 rows 0-7 / cols 8-15, a3 rows 8-15 / cols 8-15,
//   B (16x8, "col"):      b0 k 0-7, b1 k 8-15, lane l at n = l/4,
//   C (16x8, fp32):       c0,c1 at row l/4, cols 2(l%4)+{0,1}; c2,c3 at row l/4+8,
// so a C fragment's registers, rounded to bf16 and paired, are the A operand
// of the next product without any data movement.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_sm90 {

typedef __nv_bfloat16 bf16;

// 16-byte asynchronous copy to shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Fragment addresses inside a row-major bf16 tile with leading dimension ld.
// A operand: 16 rows from `row0`, 16 columns from `col0`.
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int ld, int row0, int col0,
                                              int lane) {
    return t + (row0 + lane % 16) * ld + col0 + (lane / 16) * 8;
}

// Two B operands (n-tiles n0 and n0+8, k 16 wide from k0) of a product with
// the tile's transpose, the tile holding n along rows: regs {0,1} feed n0,
// {2,3} feed n0+8.  Load with ldmatrix_x4.
__device__ __forceinline__ const bf16* frag_bt(const bf16* t, int ld, int n0, int k0,
                                               int lane) {
    return t + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8;
}

// Two B operands (n-tiles n0 and n0+8, k 16 wide from k0) of a product with
// the tile itself, the tile holding k along rows.  Load with ldmatrix_x4_trans.
__device__ __forceinline__ const bf16* frag_b(const bf16* t, int ld, int k0, int n0,
                                              int lane) {
    return t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8;
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed; rlo/rhi get the rounded values.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& rlo, float& rhi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    rlo = __low2float(h);
    rhi = __high2float(h);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace mma_sm90
