// Decode attention: one query token per sequence against a bf16 KV cache,
// for a ragged batch (per-sequence lengths), with GQA.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::_decode_kernel (the
// Pallas TPU kernel behind `decode_attention`).
//
// Bound on an H100: device-memory bytes.  Each cache row is used for 4*D
// flops per query head of its group (16 heads for chatglm3-6b, 1 for
// stablelm-3b), at most ~16 flops per byte, far below the card's ~295.  At
// the serve path's lengths (513-576 of T = 1024) chatglm3-6b reads ~2.2 MB
// a call (0.67 us at full bandwidth) and stablelm-3b ~22 MB (6.7 us), so a
// launch's fixed costs weigh as much as the bytes.
//
// Design, one launch a call:
// * One thread-block cluster of C blocks per (batch, kv head, chunk of up to
//   32 query heads of the group).  The cluster splits that sequence's live
//   rows (length read on the device) into C contiguous ranges of 16-row
//   tiles; rows at or past the length are never read.  C (1, 2, 4, 8) comes
//   from the wrapper, sized from the grid (measured: PERF.md).
// * A block streams its range through a 3-stage cp.async ring of 64-row K
//   and V tiles; each of its 4 warps takes 16 rows of a tile.  The group's
//   queries are the M = 16 operand of mma.sync m16n8k16 (zero rows pad the
//   group to 16 or 32 heads): S = Q K^T over D / 16 k-steps, an fp32 online
//   softmax (base 2) per warp, then P (rounded to bf16, as the flash kernels
//   round it) times V into fp32 accumulators, D / 8 n-tiles.  D = 80 is 5
//   k-steps and 10 n-tiles: no padding, the cache is read as it lies.
// * Each block merges its 4 warps' (m, l, acc) in warp order in shared
//   memory; then every block of the cluster combines a slice of the output
//   from all C blocks' merged partials, read through distributed shared
//   memory (generic addresses, so a thread's loads are in flight together)
//   in rank order.  Every sum has a fixed order: the same inputs give the
//   same bits.
// * Length 0 gives zeros (l = 0).  T need not be a multiple of any tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

using namespace mma_sm90;
using hopper_sm90::cluster_sync;

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;        // kv rows of one warp's step; the split's unit
constexpr int kStageRows = kWarps * kTile;
constexpr int kStages = 3;

struct Params {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const int* lengths;
    bf16* out;                  // [B, H, D] contiguous
    int H, Hkv, rep, T, chunks; // chunks: blocks' head chunks per kv head
    float scale_log2;
    int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

// Shared memory of one block: the group's queries, then the K/V ring; after
// the ring is drained its space holds the warps' partials and the block's
// merged partial, which the cluster reads.
template <int D, int MT>
struct Smem {
    static constexpr int LD = D + 8;        // bf16 row stride: ldmatrix rows on distinct banks
    static constexpr int R = 16 * MT;       // query rows (heads) of a block
    static constexpr int Q = 0;
    static constexpr int RING = Q + R * LD * 2;
    static constexpr int STAGE = 2 * kStageRows * LD * 2;      // K then V
    // after the loop, from RING: per warp acc [R][D], m [R], l [R], f [R];
    // then the merged acc [R][D], m [R], l [R]
    static constexpr int WACC = RING;
    static constexpr int WM = WACC + kWarps * R * D * 4;
    static constexpr int WL = WM + kWarps * R * 4;
    static constexpr int WF = WL + kWarps * R * 4;
    static constexpr int MACC = WF + kWarps * R * 4;
    static constexpr int MM = MACC + R * D * 4;
    static constexpr int ML = MM + R * 4;
    static constexpr int END = ML + R * 4;
    static constexpr int BYTES = END > RING + kStages * STAGE ? END : RING + kStages * STAGE;
};

// `p` in this block's shared memory, as the same location in block `rank`
// of the cluster (a generic address; `p` itself when the cluster is one block)
__device__ __forceinline__ const float* rank_ptr(const float* p, int rank, int C) {
    if (C == 1) return p;
    uint64_t r;
    asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(p), "r"(rank));
    return reinterpret_cast<const float*>(r);
}

// The bounds ask for one block an SM, which lifts ptxas's register target;
// the ring's shared memory already holds a block to 2-3 an SM at D >= 64.
// Under the default target ptxas gave <64, 1> 80 registers and spilled a
// loop-invariant shared memory address (stored before the kv loop, loaded
// in every pass of it).
template <int D, int MT>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Params p) {
    using M = Smem<D, MT>;
    constexpr int LD = M::LD, R = M::R, NT = D / 8, VPR = D / 8;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem + M::Q);

    const int C = gridDim.x, rank = blockIdx.x;          // the cluster spans x
    const int chunk = blockIdx.y % p.chunks, bg = blockIdx.y / p.chunks;
    const int g = bg % p.Hkv, b = bg / p.Hkv;
    const int h0 = chunk * R, nh = min(R, p.rep - h0);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // the group's queries (rows past nh zero), in the first copy group: issued
    // before the length is read, so the two loads' latencies overlap
    const bf16* qg = p.q + b * p.q_sb + (int64_t(g) * p.rep + h0) * p.q_sh;
    for (int i = tid; i < R * VPR; i += kThreads) {
        const int r = i / VPR, c = (i % VPR) * 8;
        cp_async16(qs + r * LD + c, r < nh ? qg + r * p.q_sh + c : qg, r < nh);
    }
    const int len = max(0, min(p.lengths[b], p.T));
    const int ntiles = (len + kTile - 1) / kTile;
    const int lo = rank * ntiles / C * kTile;
    const int hi = min(len, (rank + 1) * ntiles / C * kTile);
    const int nstages = hi > lo ? (hi - lo + kStageRows - 1) / kStageRows : 0;

    const bf16* kg = p.k + b * p.k_sb + g * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + g * p.v_sh;
    auto issue = [&](int s) {
        bf16* ks = reinterpret_cast<bf16*>(smem + M::RING + (s % kStages) * M::STAGE);
        bf16* vs = ks + kStageRows * LD;
        for (int i = tid; i < kStageRows * VPR; i += kThreads) {
            const int j = i / VPR, c = (i % VPR) * 8, row = lo + s * kStageRows + j;
            const bool ok = row < hi;
            cp_async16(ks + j * LD + c, ok ? kg + row * p.k_st + c : kg, ok);
            cp_async16(vs + j * LD + c, ok ? vg + row * p.v_st + c : vg, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nstages) issue(s);
        cp_async_commit();
    }

    float acc[MT][NT][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            m_run[mt][hr] = -INFINITY;
            l_run[mt][hr] = 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }

    for (int s = 0; s < nstages; ++s) {
        if (s + kStages - 1 < nstages) issue(s + kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const int row0 = lo + s * kStageRows + warp * kTile;
        if (row0 < hi) {
            const bf16* ks = reinterpret_cast<const bf16*>(smem + M::RING + (s % kStages) * M::STAGE);
            const bf16* vs = ks + kStageRows * LD;
            // S = Q K^T for the warp's 16 rows: two n-tiles of 8
            float sc[MT][2][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t kb[4];
                ldmatrix_x4(kb, frag_bt(ks, LD, warp * kTile, 16 * kk, lane));
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    uint32_t qa[4];
                    ldmatrix_x4(qa, frag_a(qs, LD, 16 * mt, 16 * kk, lane));
                    mma_bf16(sc[mt][0], qa, kb[0], kb[1]);
                    mma_bf16(sc[mt][1], qa, kb[2], kb[3]);
                }
            }
            // online softmax per query row (g and g + 8 of each m-tile)
            uint32_t pa[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    float mx = -INFINITY;
#pragma unroll
                    for (int j = 0; j < 2; ++j)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int row = row0 + 8 * j + 2 * (lane % 4) + e;
                            float& x = sc[mt][j][2 * hr + e];
                            x = row < hi ? x * p.scale_log2 : -INFINITY;
                            mx = fmaxf(mx, x);
                        }
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                    const float m_new = fmaxf(m_run[mt][hr], mx);
                    const float m_use = m_new == -INFINITY ? 0.f : m_new;
                    const float alpha = exp2f(m_run[mt][hr] - m_use);
                    m_run[mt][hr] = m_new;
                    float sum = 0.f;
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        float r0, r1;
                        pa[mt][2 * j + hr] = pack_bf16(exp2f(sc[mt][j][2 * hr] - m_use),
                                                       exp2f(sc[mt][j][2 * hr + 1] - m_use), r0, r1);
                        sum += r0 + r1;
                    }
                    l_run[mt][hr] = l_run[mt][hr] * alpha + sum;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        acc[mt][nt][2 * hr] *= alpha;
                        acc[mt][nt][2 * hr + 1] *= alpha;
                    }
                }
            }
            // acc += P V: P's C fragment is the A operand (a0 a1 from n-tile 0,
            // a2 a3 from n-tile 1); V's rows are the k dimension
#pragma unroll
            for (int pp = 0; pp < D / 16; ++pp) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, frag_b(vs, LD, warp * kTile, 16 * pp, lane));
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(acc[mt][2 * pp], pa[mt], vb[0], vb[1]);
                    mma_bf16(acc[mt][2 * pp + 1], pa[mt], vb[2], vb[3]);
                }
            }
        }
        __syncthreads();      // before the buffer is refilled
    }
    cp_async_wait<0>();
    __syncthreads();          // the ring's space is reused below

    // the warps' partials: acc rows 16 mt + g (+ 8), cols 8 nt + 2 (lane % 4)
    float* wacc = reinterpret_cast<float*>(smem + M::WACC);
    float* wm = reinterpret_cast<float*>(smem + M::WM);
    float* wl = reinterpret_cast<float*>(smem + M::WL);
    float* wf = reinterpret_cast<float*>(smem + M::WF);
    float* macc = reinterpret_cast<float*>(smem + M::MACC);
    float* mm = reinterpret_cast<float*>(smem + M::MM);
    float* ml = reinterpret_cast<float*>(smem + M::ML);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * mt + lane / 4 + 8 * hr;
            float l = l_run[mt][hr];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            if (lane % 4 == 0) {
                wm[warp * R + r] = m_run[mt][hr];
                wl[warp * R + r] = l;
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
                *reinterpret_cast<float2*>(wacc + (warp * R + r) * D + 8 * nt + 2 * (lane % 4)) =
                    make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
        }
    __syncthreads();
    // the block's merge of its warps, in warp order
    if (tid < R) {
        float mx = -INFINITY;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * R + tid]);
        float l = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            const float m = wm[w * R + tid];
            const float f = m == -INFINITY ? 0.f : exp2f(m - mx);
            wf[w * R + tid] = f;
            l += f * wl[w * R + tid];
        }
        mm[tid] = mx;
        ml[tid] = l;
    }
    __syncthreads();
    for (int u = tid; u < R * D / 4; u += kThreads) {
        const int r = u / (D / 4);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < kWarps; ++w) {
            const float f = wf[w * R + r];
            const float4 x = *reinterpret_cast<const float4*>(wacc + w * R * D + 4 * u);
            a.x += f * x.x;
            a.y += f * x.y;
            a.z += f * x.z;
            a.w += f * x.w;
        }
        *reinterpret_cast<float4*>(macc + 4 * u) = a;
    }
    if (C > 1) cluster_sync();
    else __syncthreads();

    // the cluster's combine, every sum in rank order.  Per query row: the
    // largest m of the C blocks, each block's factor 2^(m_c - max) and the
    // sum l (the warps' space is free now); then this block's slice of the
    // output.  Other blocks' partials are read through generic pointers
    // into their shared memory, so independent loads are in flight at once.
    float* cf = wacc;                                    // [C][R] factors
    float* cl = wl;                                      // [R] sums
    if (tid < nh) {
        float mx = -INFINITY;
        for (int c = 0; c < C; ++c) {
            const float m = *rank_ptr(mm + tid, c, C);
            cf[c * R + tid] = m;
            mx = fmaxf(mx, m);
        }
        float l = 0.f;
        for (int c = 0; c < C; ++c) {
            const float m = cf[c * R + tid];
            const float f = m == -INFINITY ? 0.f : exp2f(m - mx);
            cf[c * R + tid] = f;
            l += f * *rank_ptr(ml + tid, c, C);
        }
        cl[tid] = l;
    }
    __syncthreads();
    const int units = nh * D / 4;
    bf16* og = p.out + (int64_t(b) * p.H + int64_t(g) * p.rep + h0) * D;
    for (int u = rank * units / C + tid; u < (rank + 1) * units / C; u += kThreads) {
        const int r = u / (D / 4);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < C; ++c) {
            const float f = cf[c * R + r];
            const float4 x = *reinterpret_cast<const float4*>(rank_ptr(macc + 4 * u, c, C));
            a.x += f * x.x;
            a.y += f * x.y;
            a.z += f * x.z;
            a.w += f * x.w;
        }
        const float inv = cl[r] > 0.f ? 1.f / cl[r] : 0.f;
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(a.x * inv, a.y * inv);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a.z * inv, a.w * inv);
        uint2 o;
        o.x = *reinterpret_cast<const uint32_t*>(&lo2);
        o.y = *reinterpret_cast<const uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(og + 4 * u) = o;
    }
    if (C > 1) cluster_sync();   // no block leaves while another reads its partials
}

template <int D, int MT>
int launch(const Params& p, int B, int cluster, cudaStream_t stream) {
    const int bytes = Smem<D, MT>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B * p.Hkv * p.chunks, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, decode_kernel<D, MT>, p);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int B, int cluster, cudaStream_t stream) {
    return p.rep <= 16 ? launch<D, 1>(p, B, cluster, stream) : launch<D, 2>(p, B, cluster, stream);
}

}  // namespace

// q [B,H,D] and k/v [B,T,Hkv,D] as strided bf16 views with the last dim
// contiguous; lengths [B] int32; out [B,H,D] contiguous bf16.  strides
// holds q (batch, head), k (batch, row, head), v (batch, row, head).
// `cluster` (1, 2, 4 or 8) blocks split each sequence's live rows.  The
// wrapper checks shapes, 16-byte alignment, D in {32, 64, 80, 128} and
// rep <= 32 * (128 / D).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, int B, int H, int Hkv,
                                     int T, int D, int cluster, float scale,
                                     const int64_t* strides, void* stream) {
    if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.lengths = static_cast<const int*>(lengths);
    p.out = static_cast<bf16*>(out);
    p.H = H;
    p.Hkv = Hkv;
    p.rep = H / Hkv;
    p.T = T;
    p.chunks = p.rep <= 16 ? 1 : (p.rep + 31) / 32;
    p.scale_log2 = scale * 1.4426950408889634f;
    p.q_sb = strides[0]; p.q_sh = strides[1];
    p.k_sb = strides[2]; p.k_st = strides[3]; p.k_sh = strides[4];
    p.v_sb = strides[5]; p.v_st = strides[6]; p.v_sh = strides[7];
    if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_d<32>(p, B, cluster, st);
        case 64: return launch_d<64>(p, B, cluster, st);
        case 80: return launch_d<80>(p, B, cluster, st);
        case 128: return launch_d<128>(p, B, cluster, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
