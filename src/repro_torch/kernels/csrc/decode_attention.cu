// Decode attention: one query token per sequence against a bf16 KV cache,
// for a ragged batch (per-sequence lengths), with GQA.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel (the
// Pallas TPU kernel behind `decode_attention`).
//
// Bound on an H100: device-memory bytes.  Each cache row is used for 4*D
// flops per query head of its group (16 heads for chatglm3-6b), some 16
// flops per byte, far below the card's ~295.  At the serve path's shapes
// (B = 4, T = 1024, 2 kv heads, D = 128) the cache is ~4 MB, about 1.3 us
// at full bandwidth, so a launch costs more than the bytes.
//
// Design (split over T, as in flash-decoding):
// * The TPU kernel walks T sequentially, one grid cell per (b, group).  Here
//   that would be B * Hkv = 8 blocks on 132 SMs, so T is cut into 64-row
//   chunks and each block takes one (chunk, group, b).  It reads each K/V
//   row of its chunk once, into shared memory, for all `rep` query heads of
//   the group, and writes a partial (m, l, acc) in fp32.  Chunks at or past
//   the sequence's length exit at once and are never read.
// * A block issues all of its chunk's K/V loads into registers before it
//   stores any to shared memory, so the loads' latencies overlap.
// * A second launch combines the partials of each (b, head) with the usual
//   max-rescaled sums and writes bf16.  Both launches count as one call.
// * Length 0 gives zeros.  T need not be a multiple of the chunk: rows at or
//   past the length are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kChunk = 64;      // cache rows per block
constexpr int kThreads = 128;
constexpr int kMaxAcc = 32;     // accumulators per thread
static_assert(kThreads == 2 * kChunk, "the scores loop pairs two lanes per row");

struct Params {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const int* lengths;
    float* m_part;              // [B, H, nsplit]
    float* l_part;              // [B, H, nsplit]
    float* acc_part;            // [B, H, nsplit, D]
    bf16* out;                  // [B, H, D] contiguous
    int H, rep, T, nsplit;
    float scale_log2;
    int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int D>
struct Smem {
    // K/V row stride in 32-bit words: 2j + half lands each lane of the
    // scores loop on its own bank
    static constexpr int LDKW = D / 2 + 2;
    static size_t bytes(int rep) {
        return size_t(rep) * D * 4 + size_t(rep) * kChunk * 4 + 2 * size_t(kChunk) * LDKW * 4;
    }
};

template <int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Params p) {
    using L = Smem<D>;
    const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int len = min(p.lengths[b], p.T);
    const int t0 = split * kChunk;
    if (t0 >= len) return;  // the combine reads only chunks below the length
    const int n = min(kChunk, len - t0);
    const int rep = p.rep, tid = threadIdx.x;

    extern __shared__ __align__(16) float smem[];
    float* q_sh = smem;                                   // [rep][D], pre-scaled
    float* s_sh = q_sh + rep * D;                         // [rep][kChunk]
    uint32_t* k_sh = reinterpret_cast<uint32_t*>(s_sh + rep * kChunk);  // [kChunk][LDKW]
    uint32_t* v_sh = k_sh + kChunk * L::LDKW;

    // every load of the chunk is issued into registers before any store to
    // shared memory, so the loads' latencies overlap
    constexpr int VPR = D / 8;                       // 16-byte vectors per row
    constexpr int PER = kChunk * VPR / kThreads;     // per thread, per tensor
    const bf16* kg = p.k + b * p.k_sb + g * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + g * p.v_sh;
    uint4 kbuf[PER], vbuf[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = tid + u * kThreads, j = i / VPR, c = (i % VPR) * 8;
        kbuf[u] = vbuf[u] = make_uint4(0u, 0u, 0u, 0u);
        if (j < n) {
            kbuf[u] = *reinterpret_cast<const uint4*>(kg + (t0 + j) * p.k_st + c);
            vbuf[u] = *reinterpret_cast<const uint4*>(vg + (t0 + j) * p.v_st + c);
        }
    }
    const bf16* qg = p.q + b * p.q_sb + int64_t(g) * rep * p.q_sh;
    for (int i = tid; i < rep * VPR; i += kThreads) {
        const int r = i / VPR, c = (i % VPR) * 8;
        const uint4 u = *reinterpret_cast<const uint4*>(qg + r * p.q_sh + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            q_sh[r * D + c + 2 * e] = f.x * p.scale_log2;
            q_sh[r * D + c + 2 * e + 1] = f.y * p.scale_log2;
        }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = tid + u * kThreads, j = i / VPR, c = (i % VPR) * 8;
        uint32_t* kd = k_sh + j * L::LDKW + c / 2;
        uint32_t* vd = v_sh + j * L::LDKW + c / 2;
        kd[0] = kbuf[u].x; kd[1] = kbuf[u].y; kd[2] = kbuf[u].z; kd[3] = kbuf[u].w;
        vd[0] = vbuf[u].x; vd[1] = vbuf[u].y; vd[2] = vbuf[u].z; vd[3] = vbuf[u].w;
    }
    __syncthreads();

    // scores (base 2): a pair of lanes per cache row, each summing every
    // other word of the head dim for up to kMaxAcc heads at once (independent
    // sums), then the pair adds its halves
    {
        const int j = tid / 2, hh = tid % 2;
        const uint32_t* kr = k_sh + j * L::LDKW + hh;
        for (int r0 = 0; r0 < rep; r0 += kMaxAcc) {
            float acc[kMaxAcc];
#pragma unroll
            for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;
            if (j < n) {
#pragma unroll 4
                for (int w = 0; w < D / 2; w += 2) {
                    const float2 kf = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(kr + w));
                    const float* qw = q_sh + r0 * D + 2 * (w + hh);
#pragma unroll
                    for (int a = 0; a < kMaxAcc; ++a) {
                        if (r0 + a < rep) {
                            const float2 qf = *reinterpret_cast<const float2*>(qw + a * D);
                            acc[a] += qf.x * kf.x + qf.y * kf.y;
                        }
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < kMaxAcc; ++a) {
                acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], 1);
                if (hh == 0 && r0 + a < rep) s_sh[(r0 + a) * kChunk + j] = j < n ? acc[a] : -INFINITY;
            }
        }
    }
    __syncthreads();

    // per-head softmax over the chunk: one warp per head
    const int warp = tid / 32, lane = tid % 32;
    const int64_t part = (int64_t(b) * p.H + int64_t(g) * rep) * p.nsplit + split;
    for (int r = warp; r < rep; r += kThreads / 32) {
        float* sr = s_sh + r * kChunk;
        float mx = -INFINITY;
        for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);  // finite: the chunk holds at least one row
        float sum = 0.f;
        for (int j = lane; j < kChunk; j += 32) {
            const float e = exp2f(sr[j] - mx);
            sr[j] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
            p.m_part[part + int64_t(r) * p.nsplit] = mx;
            p.l_part[part + int64_t(r) * p.nsplit] = sum;
        }
    }
    __syncthreads();

    // acc[r][d] = sum_j p[r][j] v[j][d]; thread owns d and every HG-th head
    constexpr int HG = kThreads / D;
    const int d = tid % D, r0 = tid / D;
    float acc[kMaxAcc];
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;
    const bf16* vb = reinterpret_cast<const bf16*>(v_sh) + d;
    // four rows at a time: rows past n carry p = 0 and v = 0
    for (int j = 0; j < n; j += 4) {
        const float v0 = __bfloat162float(vb[(j + 0) * 2 * L::LDKW]);
        const float v1 = __bfloat162float(vb[(j + 1) * 2 * L::LDKW]);
        const float v2 = __bfloat162float(vb[(j + 2) * 2 * L::LDKW]);
        const float v3 = __bfloat162float(vb[(j + 3) * 2 * L::LDKW]);
#pragma unroll
        for (int a = 0; a < kMaxAcc; ++a) {
            const int r = r0 + a * HG;
            if (r < rep) {
                const float4 pr = *reinterpret_cast<const float4*>(s_sh + r * kChunk + j);
                acc[a] += pr.x * v0 + pr.y * v1 + pr.z * v2 + pr.w * v3;
            }
        }
    }
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
        const int r = r0 + a * HG;
        if (r < rep) p.acc_part[(part + int64_t(r) * p.nsplit) * D + d] = acc[a];
    }
}

template <int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(Params p) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const int len = min(p.lengths[b], p.T);
    const int ns = len > 0 ? (len + kChunk - 1) / kChunk : 0;
    const int64_t base = (int64_t(b) * p.H + h) * p.nsplit;
    float mx = -INFINITY;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, p.m_part[base + s]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {
        const float w = exp2f(p.m_part[base + s] - mx);
        l += w * p.l_part[base + s];
        acc += w * p.acc_part[(base + s) * D + d];
    }
    p.out[(int64_t(b) * p.H + h) * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

template <int D>
int launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
    const int bytes = static_cast<int>(Smem<D>::bytes(p.rep));
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_split_kernel<D><<<dim3(p.nsplit, Hkv, B), kThreads, bytes, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_combine_kernel<D><<<dim3(p.H, B), D, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the cache each split block covers; the wrapper sizes the partials
// as [B, H, ceil(T / chunk)] from it.
extern "C" int decode_attention_chunk() { return kChunk; }

// q [B,H,D] and k/v [B,T,Hkv,D] as strided bf16 views with the last dim
// contiguous; lengths [B] int32; out [B,H,D] contiguous bf16; partials fp32
// as above.  strides holds q (batch, head), k (batch, row, head), v (batch,
// row, head).  The wrapper checks shapes, 16-byte alignment, D in
// {32, 64, 128} and rep <= 32 * (128 / D).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* m_part,
                                     void* l_part, void* acc_part, int B, int H, int Hkv,
                                     int T, int D, float scale, const int64_t* strides,
                                     void* stream) {
    Params p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.lengths = static_cast<const int*>(lengths);
    p.m_part = static_cast<float*>(m_part);
    p.l_part = static_cast<float*>(l_part);
    p.acc_part = static_cast<float*>(acc_part);
    p.out = static_cast<bf16*>(out);
    p.H = H;
    p.rep = H / Hkv;
    p.T = T;
    p.nsplit = (T + kChunk - 1) / kChunk;
    p.scale_log2 = scale * 1.4426950408889634f;
    p.q_sb = strides[0]; p.q_sh = strides[1];
    p.k_sb = strides[2]; p.k_st = strides[3]; p.k_sh = strides[4];
    p.v_sb = strides[5]; p.v_st = strides[6]; p.v_sh = strides[7];
    if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
    if (p.nsplit == 0) p.nsplit = 1;  // T == 0: every length clamps to 0
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch<32>(p, B, Hkv, st);
        case 64: return launch<64>(p, B, Hkv, st);
        case 128: return launch<128>(p, B, Hkv, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
