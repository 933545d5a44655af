// RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, for bf16 rows.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::_rms_kernel (the Pallas TPU
// kernel behind `rmsnorm`).
//
// Bound on an H100: device-memory bytes.  The work is ~4 flops per element
// against 4 bytes moved (read x, write y, both bf16), some 70x below the
// card's ratio of operations to bytes.
//
// Design: one block per row, so a row's sum of squares never leaves the SM.
// Each thread moves 8 bf16 values per 16-byte load.  The sum of squares is
// kept in fp32 and reduced with warp shuffles, then across warps through
// shared memory.  The second pass reads the row again to scale it; a row is
// at most a few tens of KB and was just read by the same block, so that
// read is served from L1/L2, and device memory sees each byte about once.
// The products follow the JAX order, (x * r) * scale, in fp32, and the
// output is rounded to bf16 once.
//
// Backward (no TPU kernel: JAX differentiates the jnp reference with XLA;
// the port writes one so that a CUDA tensor never takes the plain path).
// With r = rsqrt(mean(x^2) + eps) and x^ = x r, in fp32:
//   dx     = r (dy s - x^ mean(dy s x^)),   dscale = sum over rows of dy x^.
// Bound on an H100: device-memory bytes, as the forward (read x and dy,
// write dx: 6 bytes an element).  Design: each block takes a contiguous
// range of rows; per row one pass reduces sum(x^2) and sum(dy s x) together
// (the block reduction of the forward, two values wide), the second writes
// dx.  A thread owns the same 8-column vectors in every row, so it adds its
// dy x^ into its own slots of a per-block fp32 row in shared memory with no
// race.  dscale is a sum across blocks, which run in no order: each block
// writes its partial row, and a second launch sums the partials of every
// column in block order, so the result is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int d, float eps) {
    const int row = blockIdx.x;
    const int nvec = d / 8;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * d);
    const uint4* sr = reinterpret_cast<const uint4*>(scale);
    uint4* orow = reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * d);

    float ss = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
        uint4 u = xr[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float2 f = __bfloat1622float2(h[j]);
            ss += f.x * f.x + f.y * f.y;
        }
    }
    __shared__ float partial[kThreads / 32];
    __shared__ float inv_rms;
    ss = warp_sum(ss);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
        float v = lane < kThreads / 32 ? partial[lane] : 0.f;
        v = warp_sum(v);
        if (lane == 0) inv_rms = rsqrtf(v / static_cast<float>(d) + eps);
    }
    __syncthreads();
    const float r = inv_rms;

    for (int i = threadIdx.x; i < nvec; i += kThreads) {
        uint4 u = xr[i];
        uint4 s = sr[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&s);
        uint4 o;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float2 f = __bfloat1622float2(h[j]);
            float2 w = __bfloat1622float2(g[j]);
            y[j] = __floats2bfloat162_rn((f.x * r) * w.x, (f.y * r) * w.y);
        }
        orow[i] = o;
    }
}

__device__ __forceinline__ float2 block_sum2(float a, float b, float (*red)[kThreads / 32],
                                             float2* out) {
    a = warp_sum(a);
    b = warp_sum(b);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
        float u = lane < kThreads / 32 ? red[0][lane] : 0.f;
        float v = lane < kThreads / 32 ? red[1][lane] : 0.f;
        u = warp_sum(u);
        v = warp_sum(v);
        if (lane == 0) *out = make_float2(u, v);
    }
    __syncthreads();
    return *out;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partial,
                   int rows, int d, int rows_per_block, float eps) {
    extern __shared__ float acc[];                 // [d]: this block's dscale
    __shared__ float red[2][kThreads / 32];
    __shared__ float2 sums;
    const int nvec = d / 8;
    const uint4* sr = reinterpret_cast<const uint4*>(scale);
    for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[8 * i + j] = 0.f;

    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(rows, r0 + rows_per_block);
    for (int row = r0; row < r1; ++row) {
        const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * d);
        const uint4* gr = reinterpret_cast<const uint4*>(dy + static_cast<int64_t>(row) * d);
        uint4* orow = reinterpret_cast<uint4*>(dx + static_cast<int64_t>(row) * d);
        float ss = 0.f, sd = 0.f;                  // sum x^2, sum dy s x
        for (int i = threadIdx.x; i < nvec; i += kThreads) {
            uint4 u = xr[i], w = sr[i], q = gr[i];
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&u);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&w);
            const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(xh[j]), s2 = __bfloat1622float2(sh[j]),
                             g = __bfloat1622float2(gh[j]);
                ss += f.x * f.x + f.y * f.y;
                sd += g.x * s2.x * f.x + g.y * s2.y * f.y;
            }
        }
        const float2 tot = block_sum2(ss, sd, red, &sums);
        const float r = rsqrtf(tot.x / static_cast<float>(d) + eps);
        const float m = tot.y / static_cast<float>(d) * r;   // mean(dy s x^)
        for (int i = threadIdx.x; i < nvec; i += kThreads) {
            uint4 u = xr[i], w = sr[i], q = gr[i];
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&u);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&w);
            const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&q);
            uint4 o;
            __nv_bfloat162* yo = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(xh[j]), s2 = __bfloat1622float2(sh[j]),
                             g = __bfloat1622float2(gh[j]);
                const float xa = f.x * r, xb = f.y * r;
                yo[j] = __floats2bfloat162_rn(r * (g.x * s2.x - xa * m),
                                              r * (g.y * s2.y - xb * m));
                acc[8 * i + 2 * j] += g.x * xa;
                acc[8 * i + 2 * j + 1] += g.y * xb;
            }
            orow[i] = o;
        }
    }
    float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
    for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
        for (int j = 0; j < 8; ++j) prow[8 * i + j] = acc[8 * i + j];
}

// dscale[j] = sum over the blocks' partial rows, in block order
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                         __nv_bfloat16* __restrict__ dscale, int n_part, int d) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= d) return;
    float s = 0.f;
    for (int k = 0; k < n_part; ++k) s += partial[static_cast<int64_t>(k) * d + j];
    dscale[j] = __float2bfloat16_rn(s);
}

}  // namespace

// x, out: [rows, d] contiguous bf16; scale: [d] bf16; d % 8 == 0 and all
// three pointers 16-byte aligned (the wrapper checks both).
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, void* stream) {
    if (rows > 0) {
        rmsnorm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(scale),
            static_cast<__nv_bfloat16*>(out), d, eps);
    }
    return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [rows, d] contiguous bf16; scale, dscale: [d] bf16; partial:
// [n_part, d] fp32 scratch, n_part >= 1; d % 8 == 0, pointers 16-byte
// aligned, d * 4 bytes of shared memory a block (the wrapper checks).
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy, void* dx,
                                void* partial, void* dscale, int rows, int d, int n_part,
                                float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = d * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int per_block = rows > 0 ? (rows + n_part - 1) / n_part : 0;
    rmsnorm_bwd_kernel<<<n_part, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
        static_cast<float*>(partial), rows, d, per_block, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rmsnorm_bwd_scale_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dscale), n_part, d);
    return static_cast<int>(cudaGetLastError());
}
