// Flash attention backward (causal or full, GQA) for bf16 q/k/v/out/dO: the
// dq pass and the dk/dv pass.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels behind `flash_attention_bwd`),
// with delta = rowsum(out * dO) (kernel.py:214) fused into the dq pass.
//
// Bound on an H100: tensor-core operations at the train step's shapes
// (S = 512, head dim 128).  Both passes recompute S = Q K^T and
// dP = dO V^T from the saved lse; with dQ, dK and dV that is 7 products of
// 2*D operations for each unmasked (row, col) pair, against about 10*D that
// the gradient needs at least.  The bytes are one read of q, k, v, out, dO
// and lse and one write of dq, dk, dv: the [S, T] probabilities never
// reach device memory.
//
// Design:
// * The TPU grid carries dq (or dk, dv) across a sequential grid axis in
//   VMEM.  Here each becomes a loop inside one block, so the accumulator
//   stays in registers.
// * dq pass: one block (4 warps) per (64-row q tile, head, batch), looping
//   over 64-row kv tiles up to the causal limit of its last row.  Its
//   products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands
//   fetched from shared memory with ldmatrix (mma_sm90.cuh), the next K/V
//   tile double-buffered with cp.async.
// * dk/dv pass: a cluster of C blocks (C = 1, 2, 4 or 8, chosen by the
//   wrapper) per (64-row kv tile, kv head, batch).  Block `rank` of the
//   cluster owns query heads [rank rep / C, (rank + 1) rep / C) of the GQA
//   group (none when rep < C) and loops over them and, for each, over the
//   64-row q tiles from the diagonal down, summing fp32 dk/dv partials in
//   registers.  At the end each block puts its partials in shared memory,
//   and block r sums rows [64 r / C, 64 (r + 1) / C) over the cluster
//   through distributed shared memory in rank order 0, 1, ..., C - 1 and
//   stores them: no atomics and no fp32 scratch in device memory, and the
//   same inputs give the same bits.  The grid is (C, B x Hkv, kv tiles),
//   kv tile 0 (which every q tile sees) first.
// * Each dk/dv block is one consumer warpgroup (64 kv rows) and one
//   producer warp.  The producer loads the block's K and V once with TMA,
//   then Q and dO of each (head, q tile) item into a 3-stage ring tracked by
//   `full` and `empty` mbarriers; its 32 lanes also copy that item's lse
//   and delta, which TMA cannot take: their rows are S fp32 apart, and S * 4
//   bytes need not be a multiple of 16.  q and dO are [B, H, S, D] views
//   and k, v [B, Hkv, T, D] views; each is a 4-D tensor map (D, rows, heads,
//   batch) encoded on the host in the entry point, row extents S and kv_len
//   so that TMA zero-fills past them.
// * The four products run on wgmma with the tiles in TMA's swizzled layout
//   (hopper_sm90.cuh): S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//   operands K-major in shared memory), then dV += P^T dO and
//   dK += dS^T Q (m64nDk16, P^T and dS^T from registers in the accumulator
//   layout, dO and Q MN-major).  P^T = exp(S^T * scale - lse) and
//   dS^T = P^T (dP^T - delta) are computed in registers; lse and delta are
//   read per column from shared memory.
// * One dk/dv block an SM: at D = 128 it takes 255 registers (dk, dv 128
//   fp32 + S^T, dP^T 64) without spills.  An item's products and its
//   exp/dS work run one after the other in the one warpgroup, which is what
//   holds the pass to a fraction of the bf16 rate; a 3-stage ring beat 2,
//   and issuing dV += P^T dO before dS^T is ready was slower (PERF.md).
// * The mask is explicit: q row i (absolute position q_offset + i, i < S)
//   sees kv column j when j < kv_len and, for causal, j <= q_offset + i.
//   Rows past S and columns past kv_len get zero gradients, so S and kv_len
//   need not be multiples of the tile (the Pallas grid drops such tails).
// * Inputs are strided views with a contiguous last dim, as in the forward.
//   The 1/sqrt(D) scale of dS is applied once, to dq and dk at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

using mma_sm90::bf16;

namespace {

using namespace mma_sm90;
using namespace hopper_sm90;

constexpr int BM = 64;              // rows of the block's own tile
constexpr int BN = 64;              // rows of each tile the loop walks over
constexpr int kWarps = BM / 16;     // each warp owns 16 rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const bf16* o;
    const bf16* dout;
    const float* lse;           // [B, H, S] contiguous
    float* delta;               // [B, H, S] contiguous: written by dq, read by dkv
    bf16* dq;
    bf16* dk;
    bf16* dv;
    int H, rep, S, T, kv_len, q_offset, causal;
    float scale, scale_log2;
    int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
    int64_t do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <int D>
struct Smem {
    static constexpr int LD = D + 8;     // bf16 rows padded by 16 B
    // two own tiles + two double-buffered walked tiles, and 4 x 64 floats
    static constexpr size_t bytes = size_t(2 * BM + 4 * BN) * LD * 2 + 4 * BN * 4;
};

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
    constexpr int LD = Smem<D>::LD;
    constexpr int VPR = D / 8;  // 16-byte vectors per row
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* q_sh = reinterpret_cast<bf16*>(smem);    // [BM][LD]
    bf16* do_sh = q_sh + BM * LD;                  // [BM][LD]
    bf16* k_sh = do_sh + BM * LD;                  // [2][BN][LD]
    bf16* v_sh = k_sh + 2 * BN * LD;               // [2][BN][LD]
    float* delta_sh = reinterpret_cast<float*>(v_sh + 2 * BN * LD);   // [BM]

    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* og = p.o + b * p.o_sb + h * p.o_sh;
    const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    const bf16* kg = p.k + b * p.k_sb + (h / p.rep) * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + (h / p.rep) * p.v_sh;
    const int64_t row_base = (int64_t(b) * p.H + h) * p.S;

    int kv_end = p.kv_len;
    if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + BM, p.S));
    const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

    auto load_kv = [&](int tile, int buf) {
        const int n0 = tile * BN;
        for (int i = tid; i < BN * VPR; i += kThreads) {
            const int r = i / VPR, col = (i % VPR) * 8;
            const bool ok = n0 + r < p.kv_len;
            cp_async16(k_sh + (buf * BN + r) * LD + col, ok ? kg + (n0 + r) * p.k_ss + col : kg, ok);
            cp_async16(v_sh + (buf * BN + r) * LD + col, ok ? vg + (n0 + r) * p.v_ss + col : vg, ok);
        }
    };
    for (int i = tid; i < BM * VPR; i += kThreads) {
        const int r = i / VPR, col = (i % VPR) * 8;
        const bool ok = q0 + r < p.S;
        cp_async16(q_sh + r * LD + col, ok ? qg + (q0 + r) * p.q_ss + col : qg, ok);
        cp_async16(do_sh + r * LD + col, ok ? dog + (q0 + r) * p.do_ss + col : dog, ok);
    }
    if (n_tiles > 0) load_kv(0, 0);
    cp_async_commit();

    // delta = rowsum(out * dO) in fp32: two threads per row, half a row each
    {
        const int r = tid / 2, half = tid % 2;
        float acc = 0.f;
        if (q0 + r < p.S) {
            const bf16* orow = og + (q0 + r) * p.o_ss + half * (D / 2);
            const bf16* drow = dog + (q0 + r) * p.do_ss + half * (D / 2);
#pragma unroll
            for (int i = 0; i < D / 2; i += 8) {
                const uint4 ou = *reinterpret_cast<const uint4*>(orow + i);
                const uint4 du = *reinterpret_cast<const uint4*>(drow + i);
                const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ou);
                const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float2 of = __bfloat1622float2(oh[j]), df = __bfloat1622float2(dh[j]);
                    acc += of.x * df.x + of.y * df.y;
                }
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (half == 0) {
            delta_sh[r] = acc;
            if (q0 + r < p.S) p.delta[row_base + q0 + r] = acc;
        }
    }
    __syncthreads();

    // rows g and g+8 of this warp's 16: column limit, lse (base 2), delta
    int lim[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int rr = warp * 16 + g + 8 * hr, row = q0 + rr;
        const bool ok = row < p.S;
        lim[hr] = !ok ? 0 : p.causal ? min(p.kv_len, p.q_offset + row + 1) : p.kv_len;
        lse2[hr] = ok ? p.lse[row_base + row] * kLog2e : 0.f;
        dlt[hr] = delta_sh[rr];
    }
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            load_kv(t + 1, (t + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* kb = k_sh + (t & 1) * BN * LD;
        const bf16* vb = v_sh + (t & 1) * BN * LD;

        // S = Q K^T and dP = dO V^T: 16 rows x BN columns each
        float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qf[4], df[4];
            ldmatrix_x4(qf, frag_a(q_sh, LD, warp * 16, kk * 16, lane));
            ldmatrix_x4(df, frag_a(do_sh, LD, warp * 16, kk * 16, lane));
#pragma unroll
            for (int jj = 0; jj < BN / 16; ++jj) {
                uint32_t kf[4], vf[4];
                ldmatrix_x4(kf, frag_bt(kb, LD, jj * 16, kk * 16, lane));
                ldmatrix_x4(vf, frag_bt(vb, LD, jj * 16, kk * 16, lane));
                mma_bf16(s[2 * jj], qf, kf[0], kf[1]);
                mma_bf16(s[2 * jj + 1], qf, kf[2], kf[3]);
                mma_bf16(dp[2 * jj], df, vf[0], vf[1]);
                mma_bf16(dp[2 * jj + 1], df, vf[2], vf[3]);
            }
        }

        // P = exp(S * scale - lse) on unmasked entries, dS = P (dP - delta)
        const int n0 = t * BN;
        uint32_t dsf[BN / 16][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                float ds[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + j * 8 + 2 * c + e;
                    const float pv = col < lim[hr]
                        ? exp2f(s[j][2 * hr + e] * p.scale_log2 - lse2[hr]) : 0.f;
                    ds[e] = pv * (dp[j][2 * hr + e] - dlt[hr]);
                }
                dsf[j / 2][(j % 2) * 2 + hr] = pack_bf16(ds[0], ds[1]);
            }
        }

        // dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                uint32_t kf[4];
                ldmatrix_x4_trans(kf, frag_b(kb, LD, kk * 16, dd * 16, lane));
                mma_bf16(acc[2 * dd], dsf[kk], kf[0], kf[1]);
                mma_bf16(acc[2 * dd + 1], dsf[kk], kf[2], kf[3]);
            }
        }
        __syncthreads();  // the next iteration refills this tile's buffer
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + warp * 16 + g + 8 * hr;
        if (row >= p.S) continue;
        bf16* drow = p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss + 2 * c;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8) = __floats2bfloat162_rn(
                acc[dt][2 * hr] * p.scale, acc[dt][2 * hr + 1] * p.scale);
    }
}

// ---------------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------------
constexpr int kDkvStages = 3;           // Q/dO ring depth
constexpr int kDkvThreads = 128 + 32;   // one consumer warpgroup + the producer warp

struct DkvParams {
    const float* lse;           // [B, H, S] contiguous
    const float* delta;         // [B, H, S] contiguous
    bf16* dk;
    bf16* dv;
    int H, Hkv, rep, S, T, kv_len, q_offset, causal, cluster;
    float scale, scale_log2;
    int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <int D>
struct DkvSmem {
    static constexpr int TILE = BM * D * 2;              // one [64 x D] bf16 tile
    static constexpr int STAGE = 2 * TILE + 1024;        // q, dO, lse and delta (64 floats each)
    static constexpr int RLD = D + 4;                    // fp32 partial rows, padded
    static constexpr int RED = 2 * BM * RLD * 4;         // dk and dv partials
    static constexpr int RING = kDkvStages * STAGE > RED ? kDkvStages * STAGE : RED;
    static constexpr int ring_off = 2 * TILE;            // after this block's K and V
    static constexpr int bar_off = ring_off + RING;
    static constexpr size_t bytes = bar_off + (1 + 2 * kDkvStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const DkvParams p) {
    using L = DkvSmem<D>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* k_sh = reinterpret_cast<bf16*>(smem);
    bf16* v_sh = reinterpret_cast<bf16*>(smem + L::TILE);
    unsigned char* ring = smem + L::ring_off;      // stage s: q, dO, lse, delta
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + kDkvStages;

    const int C = p.cluster;
    const int rank = C > 1 ? static_cast<int>(cluster_rank()) : 0;
    const int hk = blockIdx.y % p.Hkv, b = blockIdx.y / p.Hkv;
    const int k0 = blockIdx.z * BM;
    // this block's query heads (the wrapper's `dkv_heads` is the same split)
    const int h_lo = hk * p.rep + rank * p.rep / C;
    const int h_hi = hk * p.rep + (rank + 1) * p.rep / C;
    // q tiles that can see row k0: causal needs q_offset + i >= k0
    const int n_q = (p.S + BN - 1) / BN;
    const int qt0 = p.causal ? min(n_q, max(0, k0 - p.q_offset) / BN) : 0;
    const int per_head = n_q - qt0;
    const int n_items = k0 < p.kv_len ? (h_hi - h_lo) * per_head : 0;
    const int tid = threadIdx.x, lane = tid % 32;

    if (tid == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            mbar_init(&full[s], 1 + 32);   // TMA's expect_tx and the 32 lse/delta lanes
            mbar_init(&empty[s], 4);       // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (tid >= 128) {               // producer warp
        if (n_items > 0) {
            if (lane == 0) {
                mbar_expect_tx(kv_full, 2 * L::TILE);
                tma_load_tile<D, BM>(k_sh, &tk, kv_full, k0, hk, b);
                tma_load_tile<D, BM>(v_sh, &tv, kv_full, k0, hk, b);
            }
            for (int it = 0; it < n_items; ++it) {
                const int s = it % kDkvStages;
                if (it >= kDkvStages) mbar_wait(&empty[s], (it / kDkvStages - 1) & 1);
                const int h = h_lo + it / per_head;
                const int n0 = (qt0 + it % per_head) * BN;
                unsigned char* st = ring + s * L::STAGE;
                if (lane == 0) {
                    mbar_expect_tx(&full[s], 2 * L::TILE);
                    tma_load_tile<D, BN>(reinterpret_cast<bf16*>(st), &tq, &full[s], n0, h, b);
                    tma_load_tile<D, BN>(reinterpret_cast<bf16*>(st + L::TILE), &tdo, &full[s],
                                         n0, h, b);
                }
                float* lse_sh = reinterpret_cast<float*>(st + 2 * L::TILE);
                const int64_t base = (int64_t(b) * p.H + h) * p.S;
                for (int i = lane; i < BN; i += 32) {
                    const bool ok = n0 + i < p.S;
                    lse_sh[i] = ok ? p.lse[base + n0 + i] * kLog2e : 0.f;
                    lse_sh[BN + i] = ok ? p.delta[base + n0 + i] : 0.f;
                }
                mbar_arrive(&full[s]);
            }
        }
        __syncwarp();
    } else if (n_items > 0) {       // consumer warpgroup: kv rows k0 .. k0 + 63
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
        const uint32_t k_addr = smem_u32(k_sh), v_addr = smem_u32(v_sh);
        int krow[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) krow[hr] = k0 + warp * 16 + g + 8 * hr;
        mbar_wait(kv_full, 0);
        for (int it = 0; it < n_items; ++it) {
            const int s = it % kDkvStages;
            mbar_wait(&full[s], (it / kDkvStages) & 1);
            const unsigned char* st = ring + s * L::STAGE;
            const uint32_t q_addr = smem_u32(st), do_addr = q_addr + L::TILE;
            const float* lb = reinterpret_cast<const float*>(st + 2 * L::TILE);
            const float* db = lb + BN;
            const int n0 = (qt0 + it % per_head) * BN;

            // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BN q columns each
            float sc[BN / 2], dp[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss_m64n64(sc, desc_k<D, BM>(k_addr, 0, kk), desc_k<D, BN>(q_addr, 0, kk),
                                kk > 0);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss_m64n64(dp, desc_k<D, BM>(v_addr, 0, kk), desc_k<D, BN>(do_addr, 0, kk),
                                kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);

            // P^T on unmasked entries (0 elsewhere) and dS^T = P^T (dP^T - delta),
            // both rounded to bf16 A registers
            uint32_t pf[BN / 16][4], dsf[BN / 16][4];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int cc = j * 8 + 2 * c + e, qi = n0 + cc;
                        const bool ok = qi < p.S && krow[hr] < p.kv_len &&
                                        (!p.causal || krow[hr] <= p.q_offset + qi);
                        float& sv = sc[4 * j + 2 * hr + e];
                        sv = ok ? exp2f(sv * p.scale_log2 - lb[cc]) : 0.f;
                    }
                    const int r = 4 * j + 2 * hr, cc = j * 8 + 2 * c;
                    pf[j / 2][(j % 2) * 2 + hr] = pack_bf16(sc[r], sc[r + 1]);
                    dsf[j / 2][(j % 2) * 2 + hr] = pack_bf16(sc[r] * (dp[r] - db[cc]),
                                                             sc[r + 1] * (dp[r + 1] - db[cc + 1]));
                }
            }
            // dV += P^T dO and dK += dS^T Q
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wgmma_rs<D>(dv, pf[kk], desc_mn<D, BN>(do_addr, kk), 1);
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wgmma_rs<D>(dk, dsf[kk], desc_mn<D, BN>(q_addr, kk), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
            fence_regs(dk);
            fence_regs(pf);
            fence_regs(dsf);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage
        }
    }

    if (C == 1) {                   // the block holds the whole group: store
        if (tid >= 128) return;
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = k0 + warp * 16 + g + 8 * hr;
            if (row >= p.T) continue;
            bf16* krw = p.dk + b * p.dk_sb + hk * p.dk_sh + row * p.dk_ss + 2 * c;
            bf16* vrw = p.dv + b * p.dv_sb + hk * p.dv_sh + row * p.dv_ss + 2 * c;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
                *reinterpret_cast<__nv_bfloat162*>(krw + dt * 8) = __floats2bfloat162_rn(
                    dk[4 * dt + 2 * hr] * p.scale, dk[4 * dt + 2 * hr + 1] * p.scale);
                *reinterpret_cast<__nv_bfloat162*>(vrw + dt * 8) =
                    __floats2bfloat162_rn(dv[4 * dt + 2 * hr], dv[4 * dt + 2 * hr + 1]);
            }
        }
        return;
    }

    // The cluster's sum.  The ring is idle now: every load was consumed.
    float* red = reinterpret_cast<float*>(ring);    // [2][64][RLD]: dk, dv partials
    if (tid < 128) {
        const int warp = tid / 32, g = lane / 4, c = lane % 4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + g + 8 * hr;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
                *reinterpret_cast<float2*>(red + r * L::RLD + dt * 8 + 2 * c) =
                    make_float2(dk[4 * dt + 2 * hr], dk[4 * dt + 2 * hr + 1]);
                *reinterpret_cast<float2*>(red + (BM + r) * L::RLD + dt * 8 + 2 * c) =
                    make_float2(dv[4 * dt + 2 * hr], dv[4 * dt + 2 * hr + 1]);
            }
        }
    }
    cluster_sync();
    const int rows = BM / C, r0 = rank * rows;
    const uint32_t red_addr = smem_u32(red);
    for (int i = tid; i < 2 * rows * (D / 4); i += kDkvThreads) {
        const int which = i / (rows * (D / 4)), rem = i % (rows * (D / 4));
        const int r = r0 + rem / (D / 4), col = (rem % (D / 4)) * 4;
        const uint32_t addr = red_addr + ((which * BM + r) * L::RLD + col) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int src = 0; src < C; ++src) {      // fixed order: repeatable bits
            const float4 v = ld_cluster_f4(map_rank(addr, src));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
        const int row = k0 + r;
        if (row >= p.T) continue;
        const float sc = which == 0 ? p.scale : 1.f;
        bf16* dst = which == 0 ? p.dk + b * p.dk_sb + hk * p.dk_sh + row * p.dk_ss + col
                               : p.dv + b * p.dv_sb + hk * p.dv_sh + row * p.dv_ss + col;
        __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc, sum.y * sc);
        __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc, sum.w * sc);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = packed;
    }
    cluster_sync();                 // no block leaves while another reads its partials
}

template <int D>
int launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
    const int bytes = static_cast<int>(Smem<D>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((p.S + BM - 1) / BM, p.H, B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const DkvParams& p, int B, const int64_t* st, cudaStream_t stream) {
    CUtensorMap tq, tdo, tk, tv;
    int rc = encode_map<D>(&tq, q, B, p.H, p.S, st[0], st[1], st[2], BN);
    if (!rc) rc = encode_map<D>(&tdo, dout, B, p.H, p.S, st[12], st[13], st[14], BN);
    if (!rc) rc = encode_map<D>(&tk, k, B, p.Hkv, p.kv_len, st[3], st[4], st[5], BM);
    if (!rc) rc = encode_map<D>(&tv, v, B, p.Hkv, p.kv_len, st[6], st[7], st[8], BM);
    if (rc) return rc;
    const int bytes = static_cast<int>(DkvSmem<D>::bytes);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.cluster, B * p.Hkv, (p.T + BM - 1) / BM);
    cfg.blockDim = dim3(kDkvThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<D>, tq, tdo, tk, tv, p);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}


BwdParams make_params(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, int H, int Hkv, int S, int T, int kv_len, int q_offset,
                      int causal, float scale, const int64_t* st) {
    BwdParams p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.o = static_cast<const bf16*>(out);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.H = H;
    p.rep = H / Hkv;
    p.S = S;
    p.T = T;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    p.q_sb = st[0];  p.q_sh = st[1];  p.q_ss = st[2];
    p.k_sb = st[3];  p.k_sh = st[4];  p.k_ss = st[5];
    p.v_sb = st[6];  p.v_sh = st[7];  p.v_ss = st[8];
    p.o_sb = st[9];  p.o_sh = st[10]; p.o_ss = st[11];
    p.do_sb = st[12]; p.do_sh = st[13]; p.do_ss = st[14];
    p.dq_sb = st[15]; p.dq_sh = st[16]; p.dq_ss = st[17];
    p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
    p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
    return p;
}

}  // namespace

// Shared layout of both entry points: q, out, dO, dq [B,H,S,D] and k, v, dk,
// dv [B,Hkv,T,D] as strided bf16 views whose last dim is contiguous; lse and
// delta [B,H,S] contiguous fp32.  strides holds the (batch, head, row)
// element strides of q, k, v, out, dO, dq, dk, dv in that order.  A pointer
// the pass does not touch may be null.  The wrapper checks shapes, 16-byte
// alignment and D in {32, 64, 128}.

// dq pass: writes dq and delta = rowsum(out * dO).
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           void* delta, void* dq, int B, int H, int Hkv, int S,
                                           int T, int D, int kv_len, int q_offset, int causal,
                                           float scale, const int64_t* strides, void* stream) {
    const BwdParams p = make_params(q, k, v, out, dout, lse, delta, dq, nullptr, nullptr, H,
                                    Hkv, S, T, kv_len, q_offset, causal, scale, strides);
    if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dq<32>(p, B, st);
        case 64: return launch_dq<64>(p, B, st);
        case 128: return launch_dq<128>(p, B, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dk/dv pass: reads the delta the dq pass wrote (same stream, launched after).
// `cluster` (1, 2, 4 or 8) blocks split each kv tile's GQA group.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int B, int H, int Hkv, int S,
                                            int T, int D, int kv_len, int q_offset, int causal,
                                            int cluster, float scale, const int64_t* strides,
                                            void* stream) {
    if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    DkvParams p;
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.H = H;
    p.Hkv = Hkv;
    p.rep = H / Hkv;
    p.S = S;
    p.T = T;
    p.kv_len = kv_len;
    p.q_offset = q_offset;
    p.causal = causal;
    p.cluster = cluster;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    p.dk_sb = strides[18]; p.dk_sh = strides[19]; p.dk_ss = strides[20];
    p.dv_sb = strides[21]; p.dv_sh = strides[22]; p.dv_ss = strides[23];
    if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dkv<32>(q, k, v, dout, p, B, strides, st);
        case 64: return launch_dkv<64>(q, k, v, dout, p, B, strides, st);
        case 128: return launch_dkv<128>(q, k, v, dout, p, B, strides, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory of one dk/dv block at head dim D (0 for another D).
extern "C" int flash_attention_bwd_dkv_smem_bytes(int D) {
    switch (D) {
        case 32: return static_cast<int>(DkvSmem<32>::bytes);
        case 64: return static_cast<int>(DkvSmem<64>::bytes);
        case 128: return static_cast<int>(DkvSmem<128>::bytes);
        default: return 0;
    }
}
