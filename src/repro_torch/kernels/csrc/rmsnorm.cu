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
// write dx: 6 bytes an element).  Design, one launch:
// * A persistent grid (as many blocks of 512 threads as fit on the card at
//   once, launched cooperatively so all are resident), each block cut into
//   groups of G threads (a power of two from 32 to 512, G >= D / 16); a
//   group holds one row of x and dy in registers, two 16-byte vectors of
//   each a thread, while the next row's loads are in flight.  The row's two sums (x^2, dy s x)
//   are one warp reduction, then across the group's warps through shared
//   memory and a named barrier: each row is read from device memory once.
// * A thread owns the same columns in every row, so its dscale partial
//   stays in registers across its rows.  At the end a block sums its groups'
//   partials in group order and writes one partial row; after a grid-wide
//   barrier each block sums 32-column slices of those rows, in block order,
//   into dscale.  Every sum has a fixed order: the same inputs (on the same
//   card) give the same bits.
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

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int kBwdThreads = 512;
constexpr int kVec = 2;     // 16-byte vectors of x and of dy a thread holds of a row

// Every block of the grid waits here for all the others; the grid is
// launched cooperatively, so all its blocks are resident.  bar[0] counts
// arrivals, bar[1] is a generation the last arrival advances; both are left
// ready for the next launch.  Traps after ~2^35 cycles instead of hanging.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen_p = bar + 1;
        const unsigned gen = *gen_p;
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            const long long t0 = clock64();
            while (*gen_p == gen) {
                __nanosleep(64);
                if (clock64() - t0 > (1ll << 35)) __trap();
            }
        }
        __threadfence();
    }
    __syncthreads();
}

__device__ __forceinline__ void load_row(const uint4* xr, const uint4* gr, int nvec, int lg,
                                         int G, uint4 (&xv)[kVec], uint4 (&gv)[kVec]) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
        const int i = k * G + lg;
        xv[k] = gv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nvec) {
            xv[k] = xr[i];
            gv[k] = gr[i];
        }
    }
}

__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partial,
                   __nv_bfloat16* __restrict__ dscale, unsigned* barrier,
                   int rows, int d, int G, float eps) {
    extern __shared__ float part[];                  // [R][d]: the groups' dscale rows
    __shared__ float2 red[2][kBwdThreads / 32];      // (ss, sd) per warp, by row parity
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int R = kBwdThreads / G, grp = tid / G, lg = tid % G;
    const int nvec = d / 8, stride = gridDim.x * R;
    const float inv_d = 1.f / static_cast<float>(d);

    uint4 sv[kVec];
    float acc[kVec][8];
    {
        const uint4* sr = reinterpret_cast<const uint4*>(scale);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            const int i = k * G + lg;
            sv[k] = i < nvec ? sr[i] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
        }
    }
    int row = blockIdx.x * R + grp;
    uint4 xc[kVec], gc[kVec];
    if (row < rows)
        load_row(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * d),
                 reinterpret_cast<const uint4*>(dy + static_cast<int64_t>(row) * d), nvec, lg,
                 G, xc, gc);
    for (int it = 0; row < rows; ++it, row += stride) {
        uint4 xn[kVec], gn[kVec];
        if (row + stride < rows)        // the next row's loads, in flight meanwhile
            load_row(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row + stride) * d),
                     reinterpret_cast<const uint4*>(dy + static_cast<int64_t>(row + stride) * d),
                     nvec, lg, G, xn, gn);
        float ss = 0.f, sd = 0.f;                    // sum x^2, sum dy s x
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xc[k]);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&sv[k]);
            const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gc[k]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(xh[j]), s2 = __bfloat1622float2(sh[j]),
                             g = __bfloat1622float2(gh[j]);
                ss += f.x * f.x + f.y * f.y;
                sd += g.x * s2.x * f.x + g.y * s2.y * f.y;
            }
        }
        ss = warp_sum(ss);
        sd = warp_sum(sd);
        if (G > 32) {                                // across the group's warps
            float2* rb = red[it & 1];
            if (lane == 0) rb[warp] = make_float2(ss, sd);
            named_sync(1 + grp, G);
            ss = sd = 0.f;
            for (int w = grp * (G / 32); w < (grp + 1) * (G / 32); ++w) {
                ss += rb[w].x;
                sd += rb[w].y;
            }
        }
        const float r = rsqrtf(ss * inv_d + eps);
        const float m = sd * inv_d * r;              // mean(dy s x^)
        uint4* orow = reinterpret_cast<uint4*>(dx + static_cast<int64_t>(row) * d);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            const int i = k * G + lg;
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xc[k]);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&sv[k]);
            const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gc[k]);
            uint4 o;
            __nv_bfloat162* yo = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(xh[j]), s2 = __bfloat1622float2(sh[j]),
                             g = __bfloat1622float2(gh[j]);
                const float xa = f.x * r, xb = f.y * r;
                yo[j] = __floats2bfloat162_rn(r * (g.x * s2.x - xa * m),
                                              r * (g.y * s2.y - xb * m));
                acc[k][2 * j] += g.x * xa;
                acc[k][2 * j + 1] += g.y * xb;
            }
            if (i < nvec) orow[i] = o;
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
            xc[k] = xn[k];
            gc[k] = gn[k];
        }
    }

    // the block's partial row: its groups' partials, in group order
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
        const int i = k * G + lg;
        if (i < nvec)
#pragma unroll
            for (int e = 0; e < 8; ++e) part[grp * d + 8 * i + e] = acc[k][e];
    }
    __syncthreads();
    for (int c = tid; c < d; c += kBwdThreads) {
        float s = 0.f;
        for (int q = 0; q < R; ++q) s += part[q * d + c];
        partial[static_cast<int64_t>(blockIdx.x) * d + c] = s;
    }
    __threadfence();
    grid_barrier(barrier);

    // dscale: 32-column slices, slice j to block j % grid; 16 warps each sum
    // every 16th partial row, then warp 0 adds the 16 sums, both in order
    float* sums = part;                              // [16][32]
    for (int j = blockIdx.x; j < (d + 31) / 32; j += gridDim.x) {
        const int c = 32 * j + lane;
        float s = 0.f;
        if (c < d)
            for (int q = warp; q < static_cast<int>(gridDim.x); q += kBwdThreads / 32)
                s += __ldcg(partial + static_cast<int64_t>(q) * d + c);
        sums[warp * 32 + lane] = s;
        __syncthreads();
        if (warp == 0 && c < d) {
            float t = 0.f;
            for (int w = 0; w < kBwdThreads / 32; ++w) t += sums[w * 32 + lane];
            dscale[c] = __float2bfloat16_rn(t);
        }
        __syncthreads();
    }
}

// threads a row: a power of two from 32 to 512 with G * kVec * 8 >= d
int bwd_group(int d) {
    int g = 32;
    while (g * kVec * 8 < d && g < kBwdThreads) g *= 2;
    return g;
}

// the groups' partial rows, reused for dscale's [16][32] column sums
int bwd_smem(int d) {
    const int rows = (kBwdThreads / bwd_group(d)) * d;
    return (rows > kBwdThreads ? rows : kBwdThreads) * static_cast<int>(sizeof(float));
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
// [n_part, d] fp32 scratch, n_part >= 1: the grid takes min(n_part, the
// blocks the card holds at once, the rows' groups) blocks; barrier: two
// uint32 that are 0 before the first launch on a stream, left for the next;
// d % 8 == 0, d <= 8192, pointers 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy, void* dx,
                                void* partial, void* dscale, void* barrier, int rows, int d,
                                int n_part, float eps, void* stream) {
    const int smem = bwd_smem(d);
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_bwd_kernel,
                                                          kBwdThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms * per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int G = bwd_group(d), R = kBwdThreads / G;
    int blocks = (rows + R - 1) / R;
    blocks = blocks < 1 ? 1 : blocks;
    blocks = blocks < n_part ? blocks : n_part;
    blocks = blocks < sms * per_sm ? blocks : sms * per_sm;
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&scale),
                    const_cast<void**>(&dy), &dx, &partial, &dscale, &barrier,
                    &rows, &d, const_cast<int*>(&G), &eps};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rmsnorm_bwd_kernel), dim3(blocks),
                                    dim3(kBwdThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
