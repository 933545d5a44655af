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
