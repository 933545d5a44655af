// RMSNorm, y = x * rsqrt(mean(x^2) + eps) * scale, for bf16 rows.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::_rms_kernel (the Pallas TPU
// kernel behind `rmsnorm`).
//
// Bound on an H100: device-memory bytes.  The work is ~4 flops per element
// against 4 bytes moved (read x, write y, both bf16), some 70x below the
// card's ratio of operations to bytes.
//
// Design: one row a group of G threads (a multiple of 32), each thread
// holding V 16-byte vectors of the row in registers, so each row is read
// from device memory once and all of its loads are issued at once.  A
// thread issues its slice of `scale` together with its slice of the row.
// The sum of squares is kept in fp32, reduced with warp shuffles, then
// across the group's warps through shared memory and a named barrier of
// the group (not a barrier of the whole block).  Where there are no more
// rows than SMs (the decode steps' 4) V = 1 and a block holds one group:
// each row is spread over d / 8 threads on its own SM, so the launch is one
// memory round trip, the reduction and the store.  At many rows V = 4 (at
// d 4096: 128 threads a row, four rows a block of 512, two blocks and 64 KB
// of loads in flight an SM): fewer threads a row make the reduction
// across warps shorter than at V = 1 or 2 with the same bytes in flight.
// The products follow the JAX order, (x * r) * scale, in fp32, and the
// output is rounded to bf16 once.  The input rows may lie at a pitch wider
// than d (MLA's kv_norm reads the first 512 columns of each 576-column
// projection row in place); the output is contiguous.  Measured slower (PERF.md): one block of 256
// threads per row reading the row twice with `scale` loaded after the
// reduction (at the decode steps' rows); a persistent grid of 512-thread
// row groups with the next row's loads in flight (at many rows); V = 1, 2
// and 8 at many rows (`tools/kernel_ab.py --make-variant rms-one-vector`,
// `rms-two-vectors`, `rms-eight-vectors`).
//
// Backward (no TPU kernel: JAX differentiates the jnp reference with XLA;
// the port writes one so that a CUDA tensor never takes the plain path).
// With r = rsqrt(mean(x^2) + eps) and x^ = x r, in fp32:
//   dx     = r (dy s - x^ mean(dy s x^)),   dscale = sum over rows of dy x^.
// Bound on an H100: device-memory bytes, as the forward (read x and dy,
// write dx: 6 bytes an element).  Design, one launch:
// * A persistent grid (as many blocks of 512 threads as fit on the card at
//   once, launched cooperatively so all are resident), each block cut into
//   groups of G threads (a power of two from 32 to 512, G >= D / (8 V)); a
//   group holds one row of x and dy in registers, V 16-byte vectors of
//   each a thread, while the next row's loads are in flight: V = 2 up to
//   d 8192, V = 4 up to d 16384 (jamba's gated out_norm over d_inner).  The
//   row's two sums (x^2, dy s x) are one warp reduction, then across the
//   group's warps through shared memory and a named barrier: each row is
//   read from device memory once.
// * A thread owns the same columns in every row, so its dscale partial
//   stays with it across its rows: in registers at V = 2; at V = 4, where
//   two rows of x and dy in flight already take 64 of the 128 registers a
//   thread of a 512-thread block may hold, in its own columns of the
//   block's shared partial row (the same adds in the same order; element e
//   of vector i at e * 2048 + i, so a warp's 32 lanes touch 32 banks and a
//   thread's 8 columns are one base and constant offsets: at 8 i + e the
//   adds conflict 8 ways and the kernel ran 1.42x slower, PERF.md), and the
//   block reads `scale` from a copy in shared memory, not from registers.
//   At the end a block sums its groups' partials in group order and writes
//   one partial row; after a grid-wide barrier each block sums 32-column
//   slices of those rows, in block order, into dscale.  Every sum has a fixed order: the same inputs (on the same
//   card) give the same bits.
// * x's rows may lie at a pitch wider than d, as the forward reads them
//   (kv_norm's 512 of each 576-column row): the backward reads the same
//   rows in place; dy is read and dx written contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int kFwdThreads = 512;    // at most, a block of the forward
constexpr int kFwdMaxGroups = 8;    // row groups of a block (named barriers 1..8)
constexpr int kFwdManyRowsVec = 4;  // vectors a thread where rows outnumber the SMs

// vectors k G + lg, k < V, of a row (zeros past the row's nvec)
template <int V>
__device__ __forceinline__ void load_vecs(const uint4* src, int nvec, int lg, int G,
                                          uint4 (&v)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int i = k * G + lg;
        v[k] = i < nvec ? src[i] : make_uint4(0u, 0u, 0u, 0u);
    }
}

// One row a group of G threads; 4, 3, 2 or 1 blocks of 512 threads an SM
// at V = 1, 2, 4, 8 (32, 40, 64, 128 registers a thread)
template <int V>
__global__ void __launch_bounds__(kFwdThreads, V == 1 ? 4 : V == 2 ? 3 : V == 4 ? 2 : 1)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int rows, int d, int pitch, int G,
               float eps) {
    __shared__ float red[kFwdThreads / 32];          // the group's warp sums
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int grp = tid / G, lg = tid % G, R = blockDim.x / G;
    const int nvec = d / 8, row = blockIdx.x * R + grp;
    if (row >= rows) return;                         // the whole group
    // the row's x and this thread's slice of scale, issued together
    uint4 xv[V], sv[V];
    load_vecs<V>(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * pitch), nvec, lg,
                 G, xv);
    load_vecs<V>(reinterpret_cast<const uint4*>(scale), nvec, lg, G, sv);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            ss += f.x * f.x + f.y * f.y;
        }
    }
    ss = warp_sum(ss);
    if (G > 32) {                                    // across the group's warps
        if (lane == 0) red[warp] = ss;
        named_sync(1 + grp, G);
        ss = 0.f;
        for (int w = grp * (G / 32); w < (grp + 1) * (G / 32); ++w) ss += red[w];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const int i = k * G + lg;
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv[k]);
        const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&sv[k]);
        uint4 o;
        __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]), w = __bfloat1622float2(g[j]);
            y[j] = __floats2bfloat162_rn((f.x * r) * w.x, (f.y * r) * w.y);
        }
        if (i < nvec) orow[i] = o;
    }
}

constexpr int kBwdThreads = 512;
constexpr int kBwdNarrowD = 8192;   // the widest row at V = 2 (512 threads x 2 x 8)
constexpr int kBwdMaxD = 16384;     // at V = 4
constexpr int kBwdStride = kBwdMaxD / 8;   // a shared partial row's element stride (V = 4)

// Where element e of vector i sits in a V = 4 group's shared partial row:
// e kBwdStride + i, so the 32 lanes of a warp (32 consecutive i) touch 32
// banks; at 8 i + e (`tools/kernel_ab.py --make-variant rms-bwd-lane-major`)
// each shared add is an 8-way bank conflict
__device__ __forceinline__ int part_at(int i, int e) { return e * kBwdStride + i; }

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

// V 16-byte vectors of x and of dy a thread holds of a row
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ partial,
                   __nv_bfloat16* __restrict__ dscale, unsigned* barrier,
                   int rows, int d, int pitch, int G, float eps) {
    // the dscale partial and scale in shared memory (V = 4: one group of 512
    // threads, its row's element e of vector i at part_at(i, e)) or in
    // registers (V = 2)
    constexpr bool kSharedAcc = V > 2;
    extern __shared__ float part[];   // [R][d] the groups' dscale rows, or (V = 4)
                                      // [8][kBwdStride] and then scale
    __shared__ float2 red[2][kBwdThreads / 32];      // (ss, sd) per warp, by row parity
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int R = kBwdThreads / G, grp = tid / G, lg = tid % G;
    const int nvec = d / 8, stride = gridDim.x * R;
    const float inv_d = 1.f / static_cast<float>(d);
    float* own = part + static_cast<int64_t>(grp) * d;   // this group's partial row
    uint4* scale_sh = reinterpret_cast<uint4*>(part + kBwdMaxD);

    uint4 sv[kSharedAcc ? 1 : V];
    float acc[kSharedAcc ? 1 : V][8];
    if constexpr (kSharedAcc) {
        for (int i = tid; i < nvec; i += kBwdThreads)
            scale_sh[i] = reinterpret_cast<const uint4*>(scale)[i];
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int i = k * G + lg;
            if (i < nvec)
#pragma unroll
                for (int e = 0; e < 8; ++e) own[part_at(i, e)] = 0.f;
        }
        __syncthreads();
    } else {
        load_vecs<V>(reinterpret_cast<const uint4*>(scale), nvec, lg, G, sv);
#pragma unroll
        for (int k = 0; k < V; ++k)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
    }
    // this thread's k-th 16-byte vector of scale (zeros past the row)
    auto scale_vec = [&](int k) {
        if constexpr (kSharedAcc) {
            const int i = k * G + lg;
            return i < nvec ? scale_sh[i] : make_uint4(0u, 0u, 0u, 0u);
        } else {
            return sv[k];
        }
    };
    int row = blockIdx.x * R + grp;
    uint4 xc[V], gc[V];
    if (row < rows) {
        load_vecs<V>(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * pitch),
                     nvec, lg, G, xc);
        load_vecs<V>(reinterpret_cast<const uint4*>(dy + static_cast<int64_t>(row) * d), nvec,
                     lg, G, gc);
    }
    for (int it = 0; row < rows; ++it, row += stride) {
        uint4 xn[V], gn[V];
        if (row + stride < rows) {      // the next row's loads, in flight meanwhile
            const int64_t next = static_cast<int64_t>(row + stride);
            load_vecs<V>(reinterpret_cast<const uint4*>(x + next * pitch), nvec, lg, G, xn);
            load_vecs<V>(reinterpret_cast<const uint4*>(dy + next * d), nvec, lg, G, gn);
        }
        float ss = 0.f, sd = 0.f;                    // sum x^2, sum dy s x
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const uint4 sk = scale_vec(k);
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xc[k]);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&sk);
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
        for (int k = 0; k < V; ++k) {
            const int i = k * G + lg;
            const uint4 sk = scale_vec(k);
            const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xc[k]);
            const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&sk);
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
                if constexpr (kSharedAcc) {
                    if (i < nvec) {
                        own[part_at(i, 2 * j)] += g.x * xa;
                        own[part_at(i, 2 * j + 1)] += g.y * xb;
                    }
                } else {
                    acc[k][2 * j] += g.x * xa;
                    acc[k][2 * j + 1] += g.y * xb;
                }
            }
            if (i < nvec) orow[i] = o;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
            xc[k] = xn[k];
            gc[k] = gn[k];
        }
    }

    // the block's partial row: its groups' partials, in group order
    if constexpr (!kSharedAcc) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int i = k * G + lg;
            if (i < nvec)
#pragma unroll
                for (int e = 0; e < 8; ++e) own[8 * i + e] = acc[k][e];
        }
    }
    __syncthreads();
    for (int c = tid; c < d; c += kBwdThreads) {
        const int at = kSharedAcc ? part_at(c / 8, c % 8) : c;   // column c in a row
        float s = 0.f;
        for (int q = 0; q < R; ++q) s += part[q * d + at];
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

// The forward's geometry: V 16-byte vectors a thread, G threads a row group
// (a multiple of 32, G V 8 >= d), R groups a block.  Where there are no
// more rows than SMs, V = 1 and R = 1: each row is spread over as many
// threads as it has vectors, one block a row.  Else V is the power of two
// up to kFwdManyRowsVec that leaves the fewest lanes idle (the larger on a
// tie), and R = 512 / G (at most 8).  Either way V is doubled (to 8 at
// most) while a row would need more than 512 threads.
struct FwdShape {
    int V, G, R;
};
int fwd_group(int nvec, int V) { return ((nvec + V - 1) / V + 31) / 32 * 32; }
FwdShape fwd_shape(int rows, int d, int sms) {
    const int nvec = d / 8;
    const bool few = rows <= sms;
    FwdShape f;
    f.V = 1;
    for (int v = 2; !few && v <= kFwdManyRowsVec; v *= 2)
        if (fwd_group(nvec, v) * v <= fwd_group(nvec, f.V) * f.V) f.V = v;
    while (f.V < 8 && fwd_group(nvec, f.V) > kFwdThreads) f.V *= 2;
    f.G = fwd_group(nvec, f.V);
    f.R = few ? 1 : kFwdThreads / f.G < kFwdMaxGroups ? kFwdThreads / f.G : kFwdMaxGroups;
    f.R = f.R > 0 ? f.R : 1;
    return f;
}

// vectors a thread of the backward holds of a row
int bwd_vec(int d) { return d > kBwdNarrowD ? 4 : 2; }

// threads a row: a power of two from 32 to 512 with G * V * 8 >= d
int bwd_group(int d) {
    int g = 32;
    while (g * bwd_vec(d) * 8 < d && g < kBwdThreads) g *= 2;
    return g;
}

// the groups' partial rows, reused for dscale's [16][32] column sums; at V =
// 4 one transposed row at the widest d, then a copy of scale
int bwd_smem(int d) {
    if (bwd_vec(d) > 2)
        return kBwdMaxD * static_cast<int>(sizeof(float)) +
               d * static_cast<int>(sizeof(__nv_bfloat16));
    const int rows = (kBwdThreads / bwd_group(d)) * d;
    return (rows > kBwdThreads ? rows : kBwdThreads) * static_cast<int>(sizeof(float));
}

}  // namespace

// x: [rows, d] bf16 rows at a pitch of `pitch` elements (pitch >= d,
// pitch % 8 == 0); out: [rows, d] contiguous bf16; scale: [d] bf16;
// d % 8 == 0, d <= 32768 and all three pointers 16-byte aligned (the
// wrapper checks).
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, int pitch, float eps, void* stream) {
    if (rows <= 0) return static_cast<int>(cudaGetLastError());
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const FwdShape f = fwd_shape(rows, d, sms);
    if (f.G > kFwdThreads || pitch < d || pitch % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (rows + f.R - 1) / f.R, threads = f.R * f.G;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scale);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
    void (*kern)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int,
                 float) = rmsnorm_kernel<8>;
    if (f.V == 1) kern = rmsnorm_kernel<1>;
    else if (f.V == 2) kern = rmsnorm_kernel<2>;
    else if (f.V == 4) kern = rmsnorm_kernel<4>;
    kern<<<blocks, threads, 0, st>>>(xp, sp, op, rows, d, pitch, f.G, eps);
    return static_cast<int>(cudaGetLastError());
}

// x: [rows, d] bf16 rows at a pitch of `pitch` elements (pitch >= d,
// pitch % 8 == 0); dy, dx: [rows, d] contiguous bf16; scale, dscale: [d] bf16; partial:
// [n_part, d] fp32 scratch, n_part >= 1: the grid takes min(n_part, the
// blocks the card holds at once, the rows' groups) blocks; barrier: two
// uint32 that are 0 before the first launch on a stream, left for the next;
// d % 8 == 0, d <= 16384, pointers 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy, void* dx,
                                void* partial, void* dscale, void* barrier, int rows, int d,
                                int pitch, int n_part, float eps, void* stream) {
    if (pitch < d || pitch % 8 || d > kBwdMaxD) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = bwd_smem(d);
    void (*kern)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                 __nv_bfloat16*, float*, __nv_bfloat16*, unsigned*, int, int, int, int,
                 float) = bwd_vec(d) == 2 ? rmsnorm_bwd_kernel<2> : rmsnorm_bwd_kernel<4>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kBwdThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms * per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int G = bwd_group(d), R = kBwdThreads / G;
    int blocks = (rows + R - 1) / R;
    blocks = blocks < 1 ? 1 : blocks;
    blocks = blocks < n_part ? blocks : n_part;
    blocks = blocks < sms * per_sm ? blocks : sms * per_sm;
    void* args[] = {const_cast<void**>(&x), const_cast<void**>(&scale),
                    const_cast<void**>(&dy), &dx, &partial, &dscale, &barrier,
                    &rows, &d, &pitch, const_cast<int*>(&G), &eps};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(blocks),
                                    dim3(kBwdThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
